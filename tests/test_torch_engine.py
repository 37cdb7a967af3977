"""The port's slot InferenceEngine against the JAX package's, and the paged
engine's streaming, abort and wait calls against the JAX paged engine's.

Both engines get the f32 toy model of tests/test_engine.py (the port's
weights carried from the JAX ones) and the same request stream, submitted at
the same iterations. Greedy tokens, finish reasons and the dispatch trace
must be identical: there is no tolerance, since f32 argmax ties do not occur
on these weights."""
import json

import jax
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.models import ModelConfig as JConfig
from physics_llm_inference_tpu.models import init_params as j_init
from physics_llm_inference_tpu.serve import engine as j_engine
from physics_llm_inference_tpu.serve import paged_engine as j_paged
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models.config import \
    ModelConfig as TConfig
from physics_llm_inference_tpu_torch.models.transformer import QuantKV
from physics_llm_inference_tpu_torch.serve import engine as t_engine
from physics_llm_inference_tpu_torch.serve import paged_engine as t_paged
from torch_parity import to_numpy

# the toy model of tests/test_engine.py
TOY = dict(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_dim=128, max_seq_len=128,
           dtype="float32")
BASE = dict(num_slots=4, max_seq_len=64, prompt_buckets=(8, 16, 32))


@pytest.fixture(scope="module")
def toy():
    jcfg = JConfig(**TOY)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, TConfig(**TOY), jparams, params_from_jax(to_numpy(jparams),
                                                          device="cpu")


def _req(mod, prompt, max_tokens, **kw):
    kw.setdefault("temperature", 0.0)
    return mod.GenerationRequest(prompt_tokens=list(prompt),
                                 max_tokens=max_tokens, **kw)


def _drive(mod, params, cfg, kw, arrivals):
    """arrivals[i]: the (prompt, max_tokens, request kwargs) submitted before
    iteration i; then the engine runs to the end. Returns what is compared."""
    eng = mod.InferenceEngine(params, cfg, mod.EngineConfig(**kw))
    eng.dispatch_trace = []
    rids = []
    for wave in arrivals:
        rids += [eng.submit_request(_req(mod, p, m, **rkw))
                 for p, m, rkw in wave]
        eng.step()
    eng.run_until_done(rids)
    res = [eng.get_result(r) for r in rids]
    return dict(results=[(r.tokens, r.finish_reason) for r in res],
                trace=eng.dispatch_trace, stats=eng.stats())


def _stream(seed: int, n: int, lo: int = 2, hi: int = 20, max_tokens=(3, 12)):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(1, 100, int(rng.integers(lo, hi)))],
             int(rng.integers(*max_tokens)), {}) for _ in range(n)]


LONG = [int(x) for x in np.arange(1, 41) % 99 + 1]        # 40 tokens
REPEAT = [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8]

# name: (engine config over BASE, arrivals per iteration)
CASES = {
    "one-request": ({}, [[([5, 17, 3, 42, 8], 6, {})]]),
    "more-than-slots": (dict(num_slots=2), [_stream(1, 5)]),
    "late-arrival": ({}, [[([5, 17, 3], 8, {})], [], [([7, 1], 4, {})]]),
    "chunked-long-prompt": (
        dict(prompt_buckets=(8, 16, 32, 64), max_prefill_chunk=16),
        [[(LONG, 5, {}), ([3, 4, 5], 9, {})]]),
    "mixed-iterations": (
        dict(max_seq_len=128, max_prefill_chunk=8,
             prefill_tokens_per_iter=8),
        [[([5, 17, 3], 20, {})], [(list(range(1, 33)), 4, {})]]),
    # idle slots are parked at S - 1: a horizon of 8 walks them past the
    # cache (the write clamp; the RoPE clamp has a test of its own below)
    "h1-idle-slot": (dict(decode_horizon=1), [[([5, 17, 3, 42], 12, {})]]),
    "h8-idle-slot": (dict(decode_horizon=8),
                     [[([5, 17, 3, 42], 30, {}), ([9, 1], 21, {})]]),
    "top-k-1": ({}, [[([5, 17, 3, 42, 8], 6,
                       dict(temperature=0.8, top_k=1)),
                      ([9, 1, 4], 5, {})]]),
    "int8-pool": (dict(kv_dtype="int8"), [_stream(2, 6)]),
    "int8-h8": (dict(kv_dtype="int8", decode_horizon=8), [_stream(3, 3)]),
    "speculative-k4": (
        dict(speculative_k=4, decode_horizon=1, max_seq_len=96),
        [[(REPEAT, 24, {}), ([3, 1, 4, 1, 5, 9, 2, 6], 24, {}),
          ([5] * 7, 24, {})]]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_engine(toy, case):
    jcfg, tcfg, jparams, tparams = toy
    kw, arrivals = CASES[case]
    kw = dict(BASE, **kw)
    want = _drive(j_engine, jparams, jcfg, kw, arrivals)
    got = _drive(t_engine, tparams, tcfg, kw, arrivals)
    assert got["results"] == want["results"]
    assert got["trace"] == want["trace"]
    kinds = [t[0] for t in want["trace"]]
    horizons = {t[1] for t in want["trace"] if t[0] == "decode"}
    if case == "h8-idle-slot":
        assert 8 in horizons
    if case == "h1-idle-slot":
        assert horizons == {1}
    if case == "top-k-1":
        assert any(t[0] == "decode" and t[2] for t in want["trace"])
    if case == "chunked-long-prompt":
        assert sum(1 for t in want["trace"] if t[0] == "prefill") > 2
    if case == "mixed-iterations":
        chunks = [i for i, t in enumerate(want["trace"])
                  if t[0] == "prefill" and t[4] == 8]
        assert len(chunks) == 4 and any(
            want["trace"][i][0] == "decode"
            for i in range(chunks[0] + 1, chunks[1]))
    if case == "speculative-k4":
        assert "spec" in kinds
        st = got["stats"]["speculative"]
        assert st == want["stats"]["speculative"]
        assert st["tokens_per_dispatch"] > 1.0
    if case.startswith("int8"):
        eng = t_engine.InferenceEngine(tparams, tcfg,
                                       t_engine.EngineConfig(**kw))
        assert isinstance(eng._k, QuantKV) and eng._k.q.dtype == torch.int8


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_idle_slot_past_the_rope_table(toy, kv_dtype):
    """The model's RoPE table as long as the slots: a parked row's horizon
    reads positions past the table, which JAX clamps to its last row."""
    _, _, jparams, tparams = toy
    short = dict(TOY, max_seq_len=BASE["max_seq_len"])
    kw = dict(BASE, decode_horizon=8, kv_dtype=kv_dtype)
    arrivals = [[([5, 17, 3, 42], 30, {})]]
    want = _drive(j_engine, jparams, JConfig(**short), kw, arrivals)
    got = _drive(t_engine, tparams, TConfig(**short), kw, arrivals)
    assert got["results"] == want["results"]
    assert got["trace"] == want["trace"]
    assert 8 in {t[1] for t in want["trace"] if t[0] == "decode"}


def test_stop_tokens_match_jax_engine(toy):
    jcfg, tcfg, jparams, tparams = toy
    free = _drive(j_engine, jparams, jcfg, BASE, [[([1, 2, 3], 8, {})]])
    stop = free["results"][0][0][3]
    arrivals = [[([1, 2, 3], 8, dict(stop_tokens=(stop,))),
                 ([4, 5], 8, dict(stop_tokens=(stop, 7)))]]
    for h in (1, 8):
        kw = dict(BASE, decode_horizon=h)
        want = _drive(j_engine, jparams, jcfg, kw, arrivals)
        got = _drive(t_engine, tparams, tcfg, kw, arrivals)
        assert got["results"] == want["results"]
        assert got["trace"] == want["trace"]
        assert got["results"][0] == (free["results"][0][0][:4], "stop")


def test_speculative_engine_is_bit_identical_to_plain(toy):
    """The port's speculative engine against the port's plain engine, one
    request at a time (the JAX test's workload)."""
    _, tcfg, _, tparams = toy
    kw = dict(BASE, max_seq_len=96, decode_horizon=1)
    plain = t_engine.InferenceEngine(tparams, tcfg,
                                     t_engine.EngineConfig(**kw))
    spec = t_engine.InferenceEngine(
        tparams, tcfg, t_engine.EngineConfig(speculative_k=4, **kw))
    for p in (REPEAT, [3, 1, 4, 1, 5, 9, 2, 6], [5] * 7):
        assert plain.generate(_req(t_engine, p, 24)).tokens == \
            spec.generate(_req(t_engine, p, 24)).tokens
    st = spec.stats()["speculative"]
    assert st["dispatches"] > 0 and st["tokens_per_dispatch"] > 1.0


def _abort_run(mod, params, cfg):
    """Abort a waiting and a running request; returns their results and the
    others'."""
    eng = mod.InferenceEngine(params, cfg, mod.EngineConfig(**BASE))
    eng.dispatch_trace = []
    held = [eng.submit_request(_req(mod, [i + 1, i + 2], 20))
            for i in range(4)]
    eng.step()
    waiting = eng.submit_request(_req(mod, [9], 4))
    assert eng.abort_request(waiting)
    assert eng.get_result(waiting).finish_reason == "aborted"
    assert eng.abort_request(held[1])
    assert not eng.abort_request("no-such-request")
    eng.run_until_done(held)
    return ([(eng.get_result(r).tokens, eng.get_result(r).finish_reason)
             for r in held + [waiting]], eng.dispatch_trace)


def test_abort_matches_jax_engine(toy):
    jcfg, tcfg, jparams, tparams = toy
    got = _abort_run(t_engine, tparams, tcfg)
    assert got == _abort_run(j_engine, jparams, jcfg)
    assert got[0][1][1] == "aborted" and got[0][4] == ([], "aborted")


def test_generate_stream_and_wait_result(toy):
    jcfg, tcfg, jparams, tparams = toy
    streams = []
    for mod, params, cfg in ((j_engine, jparams, jcfg),
                             (t_engine, tparams, tcfg)):
        eng = mod.InferenceEngine(params, cfg, mod.EngineConfig(**BASE))
        streams.append(list(eng.generate_stream(_req(mod, [5, 17], 5))))
    assert streams[0] == streams[1] and len(streams[1]) == 5

    eng = t_engine.InferenceEngine(tparams, tcfg,
                                   t_engine.EngineConfig(**BASE))
    rid = eng.submit_request(_req(t_engine, [5, 17], 5))
    assert eng.wait_result(rid, timeout=0.05) is None   # nobody stepped
    eng.run_until_done([rid])
    res = eng.wait_result(rid, timeout=5)
    assert res is not None and res.tokens == streams[1]


def _step_after_submit(eng):
    """Make every submit_request step the engine twice before it returns,
    as a serving loop that wins the race to the engine lock would."""
    submit = eng.submit_request

    def submit_then_step(*a, **kw):
        rid = submit(*a, **kw)
        eng.step()
        eng.step()
        return rid

    eng.submit_request = submit_then_step


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_generate_stream_misses_no_token_stepped_before_return(toy, kind):
    """The stream's listener is registered with the request, so tokens that
    a step emits before submit_request returns still reach the stream."""
    _, tcfg, _, tparams = toy
    if kind == "slot":
        eng = t_engine.InferenceEngine(tparams, tcfg,
                                       t_engine.EngineConfig(**BASE))
    else:
        eng = t_paged.PagedInferenceEngine(tparams, tcfg,
                                           t_paged.PagedEngineConfig(**PAGED))
    want = eng.generate(_req(t_engine, [5, 17], 6)).tokens
    _step_after_submit(eng)
    streamed = list(eng.generate_stream(_req(t_engine, [5, 17], 6)))
    assert len(want) == 6 and streamed == want


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__ if isinstance(tree, (int, float)) else None


def test_stats_match_jax_engine(toy):
    """stats() keys (nested) and counters after one stream; the values are
    plain Python numbers, so /metrics serializes them; warmup() makes every
    bucket, as the JAX engine compiles them."""
    jcfg, tcfg, jparams, tparams = toy
    seen = []
    for mod, params, cfg in ((j_engine, jparams, jcfg),
                             (t_engine, tparams, tcfg)):
        eng = mod.InferenceEngine(params, cfg, mod.EngineConfig(
            speculative_k=2, **BASE))
        assert eng.warmup() > 0
        compiled = eng.stats()["prefill_compile"]
        rids = [eng.submit_request(_req(mod, p, m)) for p, m, _ in
                _stream(4, 3)]
        eng.run_until_done(rids)
        s = eng.stats()
        json.dumps(s)
        seen.append((compiled, {k: v for k, v in s.items()
                                if k != "tokens_per_s"}, _keys(s)))
    assert seen[1] == seen[0]
    assert seen[1][0] == {"compiled_shapes": 3, "hits": 0, "misses": 3}


def test_mesh_raises(toy):
    """A mesh the engine cannot serve on raises ValueError before any
    collective: slots that do not split over `data`, an axis it has no use
    for, speculative decoding. A mesh of one rank serves unsharded."""
    from types import SimpleNamespace

    from torch_dist_workers import OneRankMesh

    _, tcfg, _, tparams = toy
    dm = SimpleNamespace(world=2, shape={"data": 2, "model": 1})
    with pytest.raises(ValueError, match="num_slots 3 must divide"):
        t_engine.InferenceEngine(tparams, tcfg, t_engine.EngineConfig(
            num_slots=3), mesh=dm)
    with pytest.raises(ValueError, match="speculative"):
        t_engine.InferenceEngine(tparams, tcfg, t_engine.EngineConfig(
            num_slots=4, speculative_k=2), mesh=dm)
    ep = SimpleNamespace(world=2, shape={"data": 1, "expert": 2,
                                         "model": 1})
    with pytest.raises(ValueError, match="data, model"):
        t_engine.InferenceEngine(tparams, tcfg, mesh=ep)
    eng = t_engine.InferenceEngine(tparams, tcfg,
                                   mesh=OneRankMesh(data=1, model=1))
    assert eng.mesh is None and eng.params is tparams


# ------------------------------------------- the paged engine's new calls

PAGED = dict(num_blocks=32, block_size=8, max_batch=4,
             max_blocks_per_request=8, prompt_buckets=(8, 16, 32))


def _paged_run(mod, params, cfg):
    eng = mod.PagedInferenceEngine(params, cfg, mod.PagedEngineConfig(
        **PAGED))
    eng.dispatch_trace = []
    streamed = list(eng.generate_stream(_req(j_engine if mod is j_paged
                                             else t_engine, [5, 17, 3], 6)))
    req = j_engine if mod is j_paged else t_engine
    held = [eng.submit_request(_req(req, [i + 1] * (i + 2), 12))
            for i in range(4)]
    eng.step()
    waiting = eng.submit_request(_req(req, [9, 9], 4))
    listener: list[int] = []
    eng._listeners[held[0]].append(listener)
    aborted = [eng.abort_request(waiting), eng.abort_request(held[2]),
               eng.abort_request("no-such-request")]
    assert eng.wait_result(held[0], timeout=0.05) is None
    eng.run_until_done(held)
    res = [eng.wait_result(r, timeout=5) for r in held + [waiting]]
    return dict(streamed=streamed, aborted=aborted, listener=listener,
                results=[(r.tokens, r.finish_reason) for r in res],
                trace=eng.dispatch_trace)


def test_paged_stream_abort_wait_match_jax(toy):
    jcfg, tcfg, jparams, tparams = toy
    got = _paged_run(t_paged, tparams, tcfg)
    assert got == _paged_run(j_paged, jparams, jcfg)
    assert got["aborted"] == [True, True, False]
    assert got["results"][2][1] == "aborted"
    assert got["results"][4] == ([], "aborted")
    # the listener added after the first iteration saw every later token
    toks = got["results"][0][0]
    assert got["listener"] == toks[len(toks) - len(got["listener"]):]
    assert len(got["streamed"]) == 6
