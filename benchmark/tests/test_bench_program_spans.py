"""The readers of the program's own spans and capture counters, on a traced
run of the toy serving cell on the CPU: every serving metric is a number,
the idle split adds up to idle_share.serve, and the program's dispatch
spans are the client's dispatch stamps one for one. The toy root is
tests/toy.py's with the seven metrics added and its chat mix made busy
enough that over 200 requests are admitted before the profile stops."""
import json
import time

import pytest

from benchmark import run as bench
from benchmark.lib import spec
from benchmark.tests import toy

SERVE = ["idle_share.serve", "idle_share.serve_prepare",
         "idle_share.serve_results", "idle_share.serve_outside_step",
         "queue_wait_p95_ms.serve", "admit_to_first_p95_ms.serve",
         "capture_s.serve"]
SPLIT = SERVE[1:4]
# 40 requests/s of short outputs on a wider batch, well within what the toy
# engine serves on a CPU: the profile stops 7.5 s into a 21 s window, after
# ~300 submits
BUSY = dict(toy.CHAT, rate_rps=40.0,
            output={"dist": "lognormal", "median": 4, "sigma": 0.5,
                    "min": 2, "max": 8},
            engine=dict(toy.CHAT["engine"], max_batch=32, num_blocks=640,
                        prefill_tokens_per_iter=512))
SECONDS = 21.0


def _metric(name, unit, cells, moves, layer="serving front",
            source="program_span"):
    return {"name": name, "unit": unit, "better": "lower", "source": source,
            "layer": layer, "moves": moves, "workloads": cells}


def make_root(root):
    toy.make_root(root)
    s = json.loads((root / "BENCHMARK.json").read_text())
    serve = ["toy.serve"]
    s["per_layer"] += [
        _metric("idle_share.serve", "%", serve, "tpot_p95_ms", "device",
                "device_trace"),
        *[_metric(n, "%", serve, "tpot_p95_ms") for n in SPLIT],
        _metric("queue_wait_p95_ms.serve", "ms", serve, "ttft_p95_ms"),
        _metric("admit_to_first_p95_ms.serve", "ms", serve, "ttft_p95_ms"),
        _metric("capture_s.offline", "s", ["toy.decode"], "setup_s",
                "offline entry", "program_counter"),
        _metric("capture_s.serve", "s", serve, "setup_s",
                source="program_counter")]
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    (root / "benchmark/traffic/toy_chat.json").write_text(json.dumps(BUSY))
    return root


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The traced run's result and the Run its readers saw."""
    root = make_root(tmp_path_factory.mktemp("spans"))
    seen = {}
    reader = spec.metric_reader

    def spying(r, name):
        mod = reader(r, name)

        class Spy:
            @staticmethod
            def read(run):
                seen["run"] = run
                return mod.read(run)
        return Spy

    mp = pytest.MonkeyPatch()
    mp.setattr(spec, "metric_reader", spying)
    try:
        res = bench.run_cell(root, "toy.serve", 2**31 + 7, SECONDS, True,
                             "cpu", started=time.time())
    finally:
        mp.undo()
    return res, seen["run"]


def test_every_serving_metric_is_a_number(traced):
    res, _ = traced
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(got) >= set(SERVE)
    for name in SERVE:
        assert isinstance(got[name]["value"], float), name
    assert got["queue_wait_p95_ms.serve"]["value"] > 0
    assert got["capture_s.serve"]["value"] == 0.0     # no graph on the CPU


def test_idle_split_adds_up_to_idle_share(traced):
    got = traced[0]["metrics"]
    parts = [got[n]["value"] for n in SPLIT]
    assert min(parts) >= 0
    assert abs(sum(parts) - got["idle_share.serve"]["value"]) < 0.5


def test_dispatch_spans_are_the_clients_stamps(traced):
    from physics_llm_inference_tpu_torch.utils import tracing

    _, run = traced
    stamps = run.state["dispatches"]
    assert {d["kind"] for d in stamps} == {"prefill", "decode"}
    spans = tracing.RECORDER.snapshot().spans
    launches = sorted((s for s in spans
                       if s.name in ("prefill.launch", "decode.launch")),
                      key=lambda s: s.start_ns)
    # the span each launch follows (staging, or decode's preparation) ends
    # where the launch starts; the client stamps a dispatch in between
    staged = {(s.key, s.end_ns): s for s in spans
              if s.name in ("prefill.stage", "decode.prepare")}
    first = next(i for i, s in enumerate(launches)
                 if s.start_ns >= stamps[0]["t"])
    mine = launches[first:]
    assert len(mine) == len(stamps)
    gaps = []
    for d, s in zip(stamps, mine):
        assert s.name == d["kind"] + ".launch"
        assert staged[s.key, s.start_ns].start_ns <= d["t"] <= s.start_ns
        gaps.append(s.start_ns - d["t"])
        if d["kind"] == "prefill":
            _, bucket, rows, starts, nval = s.attrs
            assert len(rows) <= len(nval) and bucket >= max(nval)
            assert list(zip(starts, nval)) == [tuple(c) for c in d["chunks"]]
        else:
            _, horizon, _, rows, lengths = s.attrs
            assert horizon == d["horizon"]
            assert [n for _, n in sorted(zip(rows, lengths))] == \
                d["lengths"]
    # a thread switch can fall in between; most dispatches see none
    assert sorted(gaps)[len(gaps) // 2] < 1e6


def test_idle_split_of_a_made_up_slice(monkeypatch):
    """Device operations and engine spans placed by hand (trace clock =
    host clock + 1,000): each idle ns lands in the one part the engine's
    thread was in, and the parts add up to idle_share.serve."""
    from types import SimpleNamespace

    from benchmark.lib.trace import Slice
    from benchmark.metrics import _program_spans as ps
    from physics_llm_inference_tpu_torch.utils.tracing import Snapshot, Span

    off = 1000
    sl = Slice(t0=off + 100, t1=off + 200, offset=off, host=[],
               device=[(off + a, off + b, "k") for a, b in
                       [(90, 110), (120, 130), (125, 128), (160, 170),
                        (195, 260)]])
    spans = [Span("engine.step", 50, 115, 1),
             Span("decode.results", 105, 115, 1),
             Span("engine.step", 118, 185, 2), Span("schedule", 118, 150, 2),
             Span("retire", 175, 185, 2)]
    monkeypatch.setattr(ps, "_snapshot", lambda: Snapshot(spans, 0, 0))
    run = SimpleNamespace(slice=sl, state={"requests": []})
    split = ps.idle_split(run)
    # idle: 110-120, 130-160, 170-195 = 65 of 100; results 110-115 and
    # 175-185, outside 115-118 and 185-195, the rest of the steps prepare
    assert split == {"prepare": 37.0, "results": 15.0, "outside_step": 13.0}
    assert sum(split.values()) == pytest.approx(
        100 * (1 - sl.busy_s() / sl.window_s()))
    monkeypatch.setattr(ps, "_snapshot",
                        lambda: Snapshot(spans, 3, off + 100))
    assert ps.idle_split(run) is None           # the ring dropped a span
