"""The span recorder (utils/tracing.py) and what the paged engine records in
it: a bounded ring that reports what it dropped; every phase of a step
inside its `engine.step`; each request's three spans consecutive and
agreeing with its `Request` times and its listener's tokens, a preempted
request keeping its first admission; dispatch spans carrying
`dispatch_trace`'s entries. The CUDA-marked test holds the capture
counter of runtime/step_cache.py. This file imports no jax: on the card
run its CUDA test as `python -m pytest --noconftest -m cuda
tests/test_torch_tracing.py`."""
import time

import numpy as np
import pytest
import torch

from physics_llm_inference_tpu_torch.models.config import ModelConfig
from physics_llm_inference_tpu_torch.models.transformer import init_params
from physics_llm_inference_tpu_torch.runtime import step_cache
from physics_llm_inference_tpu_torch.serve import paged_engine as pe
from physics_llm_inference_tpu_torch.serve.lifecycle import \
    GenerationRequest
from physics_llm_inference_tpu_torch.utils import tracing

TOY = dict(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_dim=128, max_seq_len=128,
           dtype="float32")
# tests/test_torch_paged_engine.py's pool small enough to preempt
ENGINE = dict(num_blocks=9, block_size=8, max_batch=4,
              max_blocks_per_request=8, prompt_buckets=(8, 16, 32),
              decode_horizon=8, kv_dtype="int8")
CHILDREN = {"schedule", "prefill.stage", "prefill.launch", "prefill.results",
            "decode.prepare", "decode.launch", "decode.results", "retire"}
REQUEST = ("request.queued", "request.first_token", "request.decode")


class Stamped(list):
    """A stream listener that stamps each token on the spans' clock."""

    def __init__(self):
        super().__init__()
        self.times = []

    def append(self, tok):
        self.times.append(tracing.now())
        super().append(tok)


def _stream(seed: int, n: int):
    """n greedy requests: ragged prompts, every third one sharing a
    two-block prefix, a few with stop tokens (tests/test_torch_paged_
    engine.py's stream; that file imports jax)."""
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(1, 100, 16)]
    out = []
    for i in range(n):
        tail = [int(t) for t in rng.integers(1, 100, int(rng.integers(1, 14)))]
        prompt = shared + tail if i % 3 == 0 else tail + [int(i)]
        stop = (int(rng.integers(1, 100)),) if i % 4 == 1 else ()
        out.append((prompt, int(rng.integers(3, 12)), stop))
    return out


def _serve(enabled: bool):
    """The stream served in two waves with the recorder on or off; returns
    the engine, its Requests and listeners by id, the preempted ids and
    the spans recorded."""
    cfg = ModelConfig(**TOY)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    eng = pe.PagedInferenceEngine(params, cfg, pe.PagedEngineConfig(**ENGINE))
    eng.dispatch_trace = []
    reqs, preempted = {}, set()
    add, preempt = eng.scheduler.add_request, eng.scheduler._preempt_for

    def added(r):
        reqs[r.request_id] = r
        add(r)

    def preempt_for(n):
        victims = preempt(n)
        preempted.update(v.request_id for v in victims)
        return victims

    eng.scheduler.add_request = added
    eng.scheduler._preempt_for = preempt_for
    stream, listeners = _stream(16, 10), {}
    tracing.RECORDER.clear()
    tracing.RECORDER.enabled = enabled
    try:
        for wave in (stream[:6], stream[6:]):
            rids = []
            for p, m, st in wave:
                buf = Stamped()
                rids.append(eng.submit_request(GenerationRequest(
                    prompt_tokens=p, max_tokens=m, temperature=0.0,
                    stop_tokens=st), listener=buf))
                listeners[rids[-1]] = buf
            eng.run_until_done(rids)
        spans = tracing.RECORDER.snapshot().spans
    finally:
        tracing.RECORDER.enabled = True
        tracing.RECORDER.clear()
    return eng, reqs, listeners, preempted, spans


@pytest.fixture(scope="module")
def served():
    return _serve(True)


def test_recorder_is_bounded_and_wraps():
    rec = tracing.Recorder(capacity=8)
    for i in range(5):
        rec.record("s", 10 * i, 10 * i + 5, key=i, attrs=(i,))
    snap = rec.snapshot()
    assert [s.key for s in snap.spans] == list(range(5))
    assert snap.overwritten == 0 and snap.complete_from_ns == 0
    for i in range(5, 20):
        rec.record("s", 10 * i, 10 * i + 5, key=i, attrs=(i,))
    snap = rec.snapshot()
    assert [s.key for s in snap.spans] == list(range(12, 20))
    assert snap.spans[0] == tracing.Span("s", 120, 125, 12, (12,))
    # every dropped span ended by the 12th's end, and every held one after
    assert snap.overwritten == 12 and snap.complete_from_ns == 115
    assert all(s.end_ns > snap.complete_from_ns for s in snap.spans)
    rec.enabled = False
    rec.record("off", 0, 1)
    assert rec.snapshot() == snap
    rec.clear()
    assert rec.snapshot() == tracing.Snapshot([], 0, 0)


def test_every_phase_lies_inside_its_engine_step(served):
    _, _, _, _, spans = served
    steps = {s.key: s for s in spans if s.name == "engine.step"}
    assert len(steps) == sum(s.name == "engine.step" for s in spans) > 10
    children = [s for s in spans if s.name in CHILDREN]
    assert {s.name for s in children} == CHILDREN
    by_step: dict = {}
    for s in children:
        parent = steps[s.key]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns, s
        by_step.setdefault(s.key, []).append(s)
    for key, kids in by_step.items():       # one after the other
        kids.sort(key=lambda s: s.start_ns)
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns, (a, b)
        assert kids[0].name == "schedule" and kids[-1].name == "retire"
    assert set(by_step) == set(steps)
    assert all(s.name in CHILDREN | set(REQUEST) | {"engine.step"}
               for s in spans)


def test_request_spans_are_consecutive_and_agree_with_the_request(served):
    eng, reqs, listeners, preempted, spans = served
    assert preempted and len(reqs) == 10
    mine: dict = {}
    for s in spans:
        if s.name in REQUEST:
            mine.setdefault(s.key, []).append(s)
    assert set(mine) == set(reqs)

    def inside(t, name):
        return any(s.start_ns <= t <= s.end_ns for s in spans
                   if s.name == name)

    offsets, readmitted = [], set()
    for rid, got in mine.items():
        r, heard = reqs[rid], listeners[rid]
        assert [s.name for s in got] == list(REQUEST), rid
        queued, first, decode = got
        assert queued.end_ns == first.start_ns
        assert first.end_ns == decode.start_ns
        assert queued.start_ns <= queued.end_ns <= first.end_ns \
            <= heard.times[0] and heard.times[-1] <= decode.end_ns
        # admitted while scheduling, first token with its prefill's
        # results, finished while retiring
        assert inside(queued.end_ns, "schedule")
        assert inside(first.end_ns, "prefill.results")
        assert inside(decode.end_ns, "retire")
        assert decode.attrs == (r.finish_reason, len(r.output_tokens))
        assert eng.get_result(rid).tokens == r.output_tokens
        offsets.append(queued.start_ns - 1e9 * r.arrival_time)
        offsets.append(decode.end_ns - 1e9 * r.finish_time)
        if queued.end_ns - 1e9 * r.start_time < offsets[0] - 1e6:
            # preempted after the engine admitted it: the span keeps the
            # first admission, the Request's start_time is the last one
            assert rid in preempted
            readmitted.add(rid)
        else:
            offsets.append(queued.end_ns - 1e9 * r.start_time)
            offsets.append(first.end_ns - 1e9 * r.first_token_time)
        if len(heard) != len(r.output_tokens):
            # tokens emitted before a preemption are emitted again
            assert rid in readmitted and len(heard) > len(r.output_tokens)
        else:
            assert list(heard) == r.output_tokens
    assert readmitted
    # the host clock and Request's monotonic clock differ by one offset
    assert max(offsets) - min(offsets) < 10e6


def test_dispatch_spans_carry_dispatch_trace(served):
    eng, _, _, _, spans = served
    launches = [s for s in spans if s.name in ("prefill.launch",
                                               "decode.launch")]
    launches.sort(key=lambda s: s.start_ns)
    assert len(launches) == len(eng.dispatch_trace)
    kinds = set()
    for s, entry in zip(launches, eng.dispatch_trace):
        kinds.add(entry[0])
        assert s.name == entry[0] + ".launch"
        if entry[0] == "prefill":
            assert s.attrs == entry
        else:
            assert s.attrs[:-1] == entry
            rows, lengths = entry[3], s.attrs[-1]
            assert len(lengths) == len(rows) and min(lengths) > 0
    assert kinds == {"prefill", "decode"}


def test_recorder_off_records_nothing_and_serves_the_same(served):
    eng, reqs, _, _, _ = served
    off, off_reqs, _, _, spans = _serve(False)
    assert spans == []
    assert off.dispatch_trace == eng.dispatch_trace
    assert {k: r.output_tokens for k, r in off_reqs.items()} == \
        {k: r.output_tokens for k, r in reqs.items()}


@pytest.mark.cuda
def test_capture_s_counts_each_capture_not_each_replay():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    x = torch.zeros(1024, device=dev)
    s0 = step_cache.capture_s
    step = step_cache.CapturedStep(lambda: x.add_(1), dev)
    s1 = step_cache.capture_s
    assert s1 > s0
    for _ in range(5):
        step()
    torch.cuda.synchronize(dev)
    assert step_cache.capture_s == s1
    assert x[0].item() == 6.0           # warm-up once, five replays
    t0 = time.perf_counter()
    step_cache.CapturedStep(lambda: x.mul_(2), dev)
    took = time.perf_counter() - t0
    assert 0 < step_cache.capture_s - s1 <= took
