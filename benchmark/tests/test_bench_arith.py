"""The yardstick's arithmetic against counts worked by hand: percentiles,
operations and bytes, roofline shares, the trace's busy and idle time, and
the assignment of a serving slice's operations to dispatches."""
import types

import pytest

from benchmark.arch import mistral
from benchmark.lib import arith
from benchmark.lib.dispatch import dispatches, is_linear
from benchmark.lib.spec import load_module, find
from benchmark.lib.trace import Profiler, Slice
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent

# a small dense model: d 8, 2 q heads and 1 kv head of 4, ffn 16, vocab 10,
# 2 layers
CFG = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 2,
       "num_key_value_heads": 1, "intermediate_size": 16, "vocab_size": 10}
WB = {"layer": 1000.0, "expert_layer": 0.0, "lm_head": 120.0, "norm": 16.0,
      "embed_row": 16.0}
PEAKS = {"bf16_flops": 1e12, "hbm_bytes_s": 1e9}


def reader(name):
    return load_module(find(ROOT, "metrics", f"{name}.py"), "m_" + name)


def test_percentile_rounded_index():
    assert arith.percentile([5, 1, 4, 2, 3], 50) == 3
    # index round(0.95 * 19) = 18 of 20 sorted values
    assert arith.percentile(list(range(20)), 95) == 18
    assert arith.percentile([7.0], 95) == 7.0


def test_dense_work_by_hand():
    w = mistral.Work(CFG, WB)
    # per layer: qkv 8 x (2+2)*4 = 128, wo 8 x 8 = 64, ffn 3 x 8 x 16 = 384
    assert w.layer_params == 576 and w.linear_params == 576
    assert w.kv_bytes == 2 * 1 * (4 + 4)
    flops, nbytes = w.decode([3, 5])
    # 2 rows x 2 x (2 layers x 576 + head 80); attention 4 x 2 x 2 x 4 x
    # (3 + 5 + 2 new) pairs
    assert flops == 2 * 2 * (2 * 576 + 80) + 4 * 2 * 2 * 4 * 10
    assert nbytes == 2 * 1000 + 120 + 16 + 2 * 16 + 2 * 16 * 10
    assert w.fused_decode_bytes([3, 5]) == 2 * 1000 + 2 * 16 * 10
    # a chunk of 3 tokens after 2 cached: pairs 3 x 2 + 1 + 2 + 3
    flops, nbytes = w.prefill([(2, 3)])
    assert flops == 2 * 3 * 2 * 576 + 2 * 80 + 4 * 2 * 2 * 4 * 12
    assert nbytes == 2 * 1000 + 120 + 3 * 16 + 2 * 16 * 5
    assert w.prefill_linear_flops([(0, 4), (0, 1)]) == \
        2 * 5 * 2 * 576 + 2 * 2 * 80


def test_moe_work_counts_touched_experts():
    cfg = dict(CFG, num_local_experts=8, num_experts_per_tok=2)
    w = mistral.Work(cfg, dict(WB, expert_layer=8000.0))
    # router 8 x 8 + two experts of 3 x 8 x 16
    assert w.layer_params == 192 + 64 + 2 * 384
    assert w.linear_params == 192
    # 64 rows, top-2 of 8: an expert goes unrouted with odds 8 (3/4)^64
    assert w.expert_bytes(64) == 8000.0
    assert w.layer_weight_bytes(64) == 9000.0
    # 4 rows may leave experts unrouted: the count needs the routing
    assert w.expert_bytes(4) is None and w.decode([1, 2, 3, 4]) is None


def test_ideal_time_takes_the_larger_bound():
    assert arith.ideal_s(2e12, 1e9, PEAKS) == (2.0, "flops")
    assert arith.ideal_s(1e12, 3e9, PEAKS) == (3.0, "bytes")


def test_slice_busy_idle_and_breakdown():
    sl = Slice(t0=0, t1=100, device=[(10, 30, "a"), (20, 40, "b"),
                                     (60, 70, "a")],
               host=[(0, 100, "outer"), (45, 55, "inner")])
    assert sl.busy_s() == pytest.approx(40e-9)
    assert sl.top_ops() == [["a", 30e-9], ["b", 20e-9]]
    gaps = sl.idle_gaps()
    assert gaps[0] == ["outer", 30e-9]          # 70..100
    assert gaps[1] == ["inner", 20e-9]          # 40..60
    assert [op[2] for op in sl.ops_between(15, 61)] == ["b", "a"]


@pytest.mark.parametrize("kept", [True, False])
def test_profiler_takes_the_clock_from_its_marker(monkeypatch, kept):
    """The offset comes from the marker kernel found by name, not from a
    record that sorts before it; without the marker, the first record."""
    import torch
    from torch.autograd import profiler as ap

    def ev(start, name, cuda=True):
        return types.SimpleNamespace(
            start_ns=lambda: start, duration_ns=lambda: 10,
            name=lambda: name,
            device_type=lambda: (torch.autograd.DeviceType.CUDA if cuda
                                 else torch.autograd.DeviceType.CPU))

    events = [ev(5_000, "stray"), ev(9_000, "decode"),
              ev(6_000, "host op", cuda=False)]
    if kept:
        events.append(ev(7_000, "at::cuda::spin_kernel(long)"))
    monkeypatch.setattr(ap, "_disable_profiler",
                        lambda: types.SimpleNamespace(events=lambda: events))
    monkeypatch.setattr(
        "time.time_ns", lambda: 3_000)       # the host clock at the stop
    prof = Profiler(torch.device("cpu"))
    prof._prof, prof._clock, prof._t0 = object(), 1_000, 2_000
    sl = prof.stop()
    offset = 6_000 if kept else 4_000
    assert sl.offset == offset
    assert (sl.t0, sl.t1) == (2_000 + offset, 3_000 + offset)
    assert [d[2] for d in sl.device][0] == "stray"
    assert [h[2] for h in sl.host] == ["host op"]


def _run(**kw):
    run = types.SimpleNamespace(peaks=PEAKS, work=mistral.Work(CFG, WB),
                                log=lambda *a: None, **kw)
    return run


def test_k4_roofline_from_its_launches():
    # two launches (new_tokens 2) of 1 us each, two rows of prompts 3 and 5
    sl = Slice(t0=0, t1=10_000, device=[
        (100, 1100, "void fused_decode_stream_kernel<0, false>(Params)"),
        (1200, 1300, "other"),
        (2000, 3000, "void fused_decode_stream_kernel<0, false>(Params)")],
        host=[])
    run = _run(slice=sl, mix={"new_tokens": 2},
               state={"batches": [{"traced": True,
                                   "prompts": [[1] * 3, [1] * 5]}]})
    nbytes = (2 * 1000 + 2 * 16 * (8 + 2)) + (2 * 1000 + 2 * 16 * (10 + 2))
    assert reader("k4_roofline").read(run) == pytest.approx(
        100 * nbytes / 1e9 / 2e-6)
    # a launch the trace lost: each traced launch counts the mean step's
    # bytes (steps 0-2: 2,320, 2,384 and 2,448), and a line says so
    logged = []
    run.log, run.mix = logged.append, {"new_tokens": 3}
    assert reader("k4_roofline").read(run) == pytest.approx(
        100 * 2 * 2384 / 1e9 / 2e-6)
    assert logged == ["k4_roofline: 2 of 3 launches traced (the trace lost "
                      "records); each counts the mean step's bytes"]
    run.mix = {"new_tokens": 1}          # more launches than steps: nothing
    assert reader("k4_roofline").read(run) is None


def _moe_run(ffn, layers=2, rows=64):
    """A run whose traced batch of `rows` is one decode step of `layers`
    per-op MoE layers (8 experts, top-2), each op 100 ns, `ffn` the ops
    after wo's K1."""
    cfg = dict(CFG, num_local_experts=8, num_experts_per_tok=2)
    work = mistral.Work(cfg, dict(WB, expert_layer=8000.0))
    layer = ["ln", "int8_matmul_stream_kernel", "int8_matmul_finalize",
             "rope", "int8_kv_decode_attention_kernel",
             "int8_matmul_stream_kernel", "int8_matmul_finalize", *ffn]
    names = layer * layers + ["rmsnorm_rows", "lmhead_fold"]
    ops, t = [], 0
    for n in names:
        ops.append((t, t + 100, n))
        t += 100
    sl = Slice(t0=0, t1=t, device=ops, host=[])
    logged = []
    return types.SimpleNamespace(
        peaks=PEAKS, work=work, log=logged.append, logged=logged, slice=sl,
        mix={"new_tokens": 1},
        state={"batches": [{"traced": True, "prompts": [[1]] * rows}]})


# the dequantized stacks and bmm, and the grouped expert kernels that took
# their place in decode
@pytest.mark.parametrize("experts", [
    ["dequant", "bmm"],
    ["moe_expert_stream_kernel", "moe_expert_finalize_kernel"]])
def test_moe_ffn_roofline_finds_the_ffn_between_wo_and_the_next_layer(
        experts):
    run = _moe_run(["router", *experts])
    # layer 1's FFN: router, the two expert ops, then layer 2's ln
    # (400 ns); layer 2's: router and the expert ops (300 ns)
    per = 8000.0 + 8 * 8 * 2
    assert reader("moe_ffn_roofline").read(run) == pytest.approx(
        100 * 2 * per / 1e9 / 700e-9)
    assert run.logged == []


@pytest.mark.parametrize("fault", ["no slice", "no peaks", "no batch",
                                   "routing unknown", "no regions",
                                   "a region more"])
def test_moe_ffn_roofline_logs_why_it_reads_nothing(fault):
    run = _moe_run(["router", "moe_expert_stream_kernel"])
    if fault == "no slice":
        run.slice = None
    elif fault == "no peaks":
        run.peaks = None
    elif fault == "no batch":
        run.state = {}
    elif fault == "routing unknown":
        run = _moe_run(["router"], rows=4)
    elif fault == "no regions":
        run = _moe_run([], layers=0)
    else:
        run = _moe_run(["router", "moe_expert_stream_kernel"], layers=3)
    assert reader("moe_ffn_roofline").read(run) is None
    assert len(run.logged) == 1
    assert run.logged[0].startswith("moe_ffn_roofline: ")


@pytest.mark.parametrize("lost", ["int8_kv_decode_attention_kernel",
                                  "int8_matmul_finalize"])
def test_moe_ffn_roofline_reads_the_regions_a_lossy_trace_kept_whole(lost):
    run = _moe_run(["router", "moe_expert_stream_kernel",
                    "moe_expert_finalize_kernel"])
    ops = run.slice.device
    # the trace lost layer 2's K2 launch, or the finalize of its wo
    gone = max(i for i, op in enumerate(ops) if op[2] == lost)
    run.slice = Slice(t0=run.slice.t0, t1=run.slice.t1,
                      device=ops[:gone] + ops[gone + 1:], host=[])
    # layer 1's region alone: router, the expert pair, layer 2's ln (400 ns)
    per = 8000.0 + 8 * 8 * 2
    assert reader("moe_ffn_roofline").read(run) == pytest.approx(
        100 * per / 1e9 / 400e-9)
    assert run.logged == ["moe_ffn_roofline: 1 of 2 FFN regions traced "
                          "whole (the trace lost records); read over those"]


def test_serving_ops_go_to_the_dispatch_stamped_before_them():
    sl = Slice(t0=1000, t1=5000, offset=1000, host=[], device=[
        (1100, 1500, "int8_matmul_wgmma_kernel<256>"),
        (1600, 1700, "sm90_xmma_gemm_bf16bf16"),
        (1800, 1900, "argmax"),
        (2100, 2300, "void fused_decode_stream_kernel<0, true>"),
        (2400, 2600, "void fused_decode_stream_kernel<0, true>"),
        (2700, 2800, "sample")])
    spans = [{"kind": "prefill", "t": 50, "chunks": [(0, 3)]},
             {"kind": "decode", "t": 1050, "horizon": 2, "lengths": [4]}]
    run = _run(slice=sl, state={"dispatches": spans})
    got = dispatches(run)
    assert [len(ops) for _, ops in got] == [3, 3]
    assert [is_linear(op[2]) for op in got[0][1]] == [True, True, False]
    k8 = reader("k8_roofline.serve").read(run)
    nbytes = (2 * 1000 + 2 * 16 * 5) + (2 * 1000 + 2 * 16 * 6)
    assert k8 == pytest.approx(100 * nbytes / 1e9 / 400e-9)
    gemm = reader("prefill_gemm_roofline.serve").read(run)
    assert gemm == pytest.approx(
        100 * (2 * 3 * 2 * 576 + 2 * 80) / 1e12 / 500e-9)
    # decode dispatch: 2100..2800 on the device
    mfu = reader("mfu.serve_decode").read(run)
    t = sum(arith.ideal_s(*run.work.decode([4 + j]), PEAKS)[0]
            for j in range(2))
    assert mfu == pytest.approx(100 * t / 700e-9)
