#!/usr/bin/env python3
"""Smoke run of the PyTorch port (physics_llm_inference_tpu_torch) on one GPU.

    python3 chip_smoke.py

The phase clock (phase 3b) alone, from the repository's root:

    python3 -c "import torch, chip_smoke as s; s.phase_clock(torch.device('cuda'))"

Parts alone, after phases 1-2 (each tree's package beside the script: a
copy of this script in another tree's root measures that tree):

    python3 chip_smoke.py [--k1] [--attention] [--fused] [--decode] [--serving] [--frontend] [--copy]

--k1: phase 3's K1 sweep and K3; --attention: phase 3's K2 (S = 256,
1,024, 4,096), K6 and K7; --fused: K4 in each mode at its seeds, K4's
capture and replay, and K8, with output digests, and the phase clock;
--decode: phase 5's cached_generate at prompt 128 in each K4 mode and on
the per-op path, each against the eager loop; --serving: the
bench_serving7b waves, captured and eager, then one wave under
torch.profiler; --frontend: phase 5c; --copy: phase 3's K9-K12.

Phases, each of which raises on failure (exit code != 0, no final line):
1. device: the card's name and power limit (nvidia-smi); no CUDA -> fail;
2. build: nvcc compiles csrc/*.cu into build/, one process per source, all
   in parallel (kernels/_build.py), and each kernel entry's registers and
   spill bytes are logged from ptxas's report;
3. each CUDA kernel (K1 int8_matmul, K2 int8_kv_decode_attention, K3
   lmhead_greedy, K4 fused_decode_step in its modes W8A16, W4A16 and W8A8,
   K5 flash_attention, K6 int8_paged_decode_attention, K7
   paged_decode_attention, K8 fused_paged_decode_step, K9 tiled_matmul, K10
   stream_copy, K11 strided_copy, K12 vector_add) against its plain torch
   version at the main paths' shapes, with the tolerance stated, and both
   timed with CUDA events, beside the kernel's bound at that shape and,
   where one PyTorch call computes the same function, that call's time;
   3b. the phase clock: one clocked launch of each K4 mode at 32 layers
   and of K8 at 32 layers in the engine's geometry, each phase's mean us a
   layer and each GEMM phase's GB/s of weights, then each kernel's
   attention phase with the GB/s of its live KV;
   K2 also at S = 1,024 and 4,096, each with the GB/s of its live KV; K2,
   K6 and K7 each launched twice on the same inputs, bit-equal; K7 also at
   head_dim 120;
   K1 at each 7B linear for M = 64-2047 and the lm_head, on each route,
   beside torch._weight_int8pack_mm and a bf16 torch.mm yardstick;
   K5 also at the paged chunk's shape, GQA groups 1 and 8, head_dim 64 and
   a ragged Sq, with a sweep against SDPA at S = 512-8192 (logged); K9 also
   on a ragged bf16 shape and an N % 8 != 0 one, each through its route's
   launch counter (wgmma + TMA, WMMA, f32); K10, K11 and K12 timed beside
   the library call, and byte-equal at ragged and unaligned shapes; K4 W8A16 and W4A16 under
   check_fused's rules at eight seeds, their x_out errors side by side; K4
   captured once in a CUDA graph and replayed at two write slots, bit-equal
   to eager launches;
4. slice parity: a model at the 7B widths with 2 layers runs prefill plus 8
   teacher-forced decode steps with the kernels and again with the kernels'
   entry points swapped for their plain versions (here, not in the package),
   on the per-op and the fused dense decode paths (the fused one in W8A16,
   W4A16 with INT4 weights and W8A8 with act_quant="int8") and on the paged
   path in the paged engine's default geometry (chunked flash prefill into
   INT8 block pools, fused paged decode); final hidden states or logits and
   greedy tokens are compared;
5. the main paths at full size, on the 7B-class config (32 layers)
   initialized on the card from a seed: cached_generate at batch 64 with 128
   greedy tokens over an INT8 KV cache in the default ModelConfig at prompt
   128 and 512, then on the per-op decode path (K2), then at prompt 128 in
   W4A16 (INT4 block weights) and in W8A8, each of which must launch its K4
   mode once a decode step; each run's decode loop is a CUDA graph captured
   in a warm run and replayed, and its greedy tokens must equal the eager
   loop's (DecodeLoop stepped here, with no graph) on the same weights,
   decode ms a step and tok/s of both logged (the per-op path also the
   host's share of a step); then bench/headline.main(), bench.py's
   protocol, in its default W8A16 configuration (its JSON on a line of its
   own); then the paged serving engine in the scripts/bench_serving7b.py
   configuration (INT8 pools, 512-token blocks, batch 64, horizon 8, radix
   on), its dispatch steps captured by warmup() and at first use, serving
   three waves of 128 requests of prompt 576 (every fourth behind one of 8
   shared 512-token prefixes) for 64 greedy tokens each, which decode
   through K8, each one workload repeated (the radix cache emptied, then
   an unmeasured warm wave, then the same requests), and the same stream
   through the engine with
   eager dispatch functions: tokens, finish reasons and dispatch_trace
   identical, the median wall of each, K1's calls by route and M counted
   over the eager waves; then a profiled wave (the kernels' share of the
   wall); then its per-op routes, INT8 pools at block size 16 (K6) and bf16
   pools (K7). Every kernel of each path must have launched during that
   path's timed run;
   5c. the serving front end on the same weights: the slot InferenceEngine
   (64 slots of 1,024 positions, INT8 pool, horizon 8), captured by
   warmup() on this thread, behind InferenceServer(port=0) with a
   tokenizer that maps each character to its code point: 128 chat requests
   (prompts of 32-576 tokens from a seed, chunked above 512; 64 greedy
   tokens; every fourth over SSE) from 32 client threads, which must launch
   K1 (both routes), K5 and K4 once a decode step and nothing of K2, K3 or
   K8; the same requests from 32 threads straight to the engine, and all
   at once; a full 64-slot horizon's ms a step; then the engine with eager
   dispatch functions (eager_slot_engine_class) on the same requests:
   tokens, finish reasons and dispatch_trace identical to the captured
   engine's, and every HTTP response's tokens equal to its request's
   there; then speculative_k=4 on repetitive prompts, captured and eager
   identical, beside the plain engine (drafts accepted, tokens equal to
   the plain engine's); then the paged engine in the bench_serving7b
   geometry behind the server with no warmup() (its steps captured on the
   serving loop's thread): 64 requests through K8, and abort_request on a
   running request, which must finish "aborted"; then
   `cli serve --config llama7b --int8 --check`;
6. the kernel microbenchmark path at the JAX package's default sizes, through
   its public functions: bench_gemm with K9 and with torch.matmul (4096^3
   bf16), bench_gemv (8 x 4096 x 4096, bf16 and K1 int8), bench_attention
   (seq 2048, K5 and the grouped SDPA), bench_precision,
   measure_access_patterns (K10, K11), vector_add (K12), then
   bench.suite.main in full. K9-K12, K1 and K5 must have launched, the
   suite must give the JAX suite's keys, and no roofline_fraction may
   exceed 1.05.
Then one JSON line with each kernel's numbers (launches summed over the
timed runs of phases 5, 5c and 6), and the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "physics_llm_inference_tpu_torch"

# 7B-class GQA model of bench.py (hidden 4096, 32 layers, 32q/8kv, FFN 11008)
WIDTHS = dict(vocab_size=32000, hidden_dim=4096, num_heads=32,
              num_kv_heads=8, intermediate_dim=11008, max_seq_len=2048,
              dtype="bfloat16")
BATCH, PROMPT, LONG_PROMPT, NEW_TOKENS = 64, 128, 512, 128
SEED = 0
# the paged engine of scripts/bench_serving7b.py
SERVE_REQUESTS, SERVE_PROMPT, SERVE_TOKENS, SHARED_PREFIXES = 128, 576, 64, 8
KERNELS = {  # name: (module, launch counter, CUDA source, TPU kernel replaced)
    # K1's two routes: the weight stream (decode rows) and wgmma (prefill
    # rows), each its own kernel and launch counter
    "int8_matmul": ("int8_matmul", "stream_launches", "csrc/int8_matmul.cu",
                    "physics_llm_inference_tpu/kernels/int8_matmul.py:52"),
    "int8_matmul_prefill": (
        "int8_matmul", "wgmma_launches", "csrc/int8_matmul.cu",
        "physics_llm_inference_tpu/kernels/int8_matmul.py:52"),
    "int8_kv_decode_attention": (
        "int8_kv_attention", "launches", "csrc/int8_kv_attention.cu",
        "physics_llm_inference_tpu/kernels/int8_kv_attention.py:148"),
    "lmhead_greedy": ("lmhead", "launches", "csrc/lmhead.cu",
                      "physics_llm_inference_tpu/kernels/lmhead.py:92"),
    "fused_decode_step": (
        "fused_decode", "launches", "csrc/fused_decode.cu",
        "physics_llm_inference_tpu/kernels/fused_decode.py:1200"),
    # the same TPU kernel's other two bodies, each its own template instance
    # and launch counter
    "fused_decode_step_w4a16": (
        "fused_decode", "w4a16_launches", "csrc/fused_decode.cu",
        "physics_llm_inference_tpu/kernels/fused_decode.py:1200"),
    "fused_decode_step_w8a8": (
        "fused_decode", "w8a8_launches", "csrc/fused_decode.cu",
        "physics_llm_inference_tpu/kernels/fused_decode.py:1200"),
    "flash_attention": (
        "flash_attention", "launches", "csrc/flash_attention.cu",
        "physics_llm_inference_tpu/kernels/flash_attention.py:310"),
    "int8_paged_decode_attention": (
        "paged_attention", "int8_paged_launches", "csrc/paged_attention.cu",
        "physics_llm_inference_tpu/kernels/paged_attention.py:223"),
    "paged_decode_attention": (
        "paged_attention", "paged_launches", "csrc/paged_attention.cu",
        "physics_llm_inference_tpu/kernels/paged_attention.py:81"),
    "fused_paged_decode_step": (
        "fused_decode", "paged_launches", "csrc/fused_decode.cu",
        "physics_llm_inference_tpu/kernels/fused_decode.py:1002"),
    "tiled_matmul": ("matmul", "launches", "csrc/tiled_matmul.cu",
                     "physics_llm_inference_tpu/kernels/matmul.py:42"),
    "stream_copy": ("membench", "stream_launches", "csrc/membench.cu",
                    "physics_llm_inference_tpu/kernels/membench.py:29"),
    "strided_copy": ("membench", "strided_launches", "csrc/membench.cu",
                     "physics_llm_inference_tpu/kernels/membench.py:44"),
    "vector_add": ("hello_pallas", "launches", "csrc/vector_add.cu",
                   "physics_llm_inference_tpu/kernels/hello_pallas.py:23"),
}
# K4's modes: the block weights' init, cfg.act_quant, the KERNELS entry
# whose counter the mode's launches go to, the weight bits of the HBM floor
FUSED_MODES = {"w8a16": ("init_params_int8", "none", "fused_decode_step", 8),
               "w4a16": ("init_params_int4", "none",
                         "fused_decode_step_w4a16", 4),
               "w8a8": ("init_params_int8", "int8",
                        "fused_decode_step_w8a8", 8)}
# the microbenchmark path (phase 6) must launch these
MICRO_KERNELS = ("tiled_matmul", "stream_copy", "strided_copy", "vector_add",
                 "int8_matmul", "flash_attention")


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def ptxas_report(logs: dict) -> list:
    """One line a source from nvcc's -Xptxas -v report: each kernel entry's
    registers and spill bytes (stores/loads)."""
    import re
    import shutil

    lines = []
    for src, text in sorted(logs.items()):
        entries, props, cur = {}, None, None
        for ln in text.splitlines():
            if m := re.search(r"Compiling entry function '(\w+)'", ln):
                cur = m.group(1)
                entries[cur] = [None, None, None]
            elif m := re.search(r"Function properties for (\w+)", ln):
                props = m.group(1)
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                                r"loads", ln):
                if props in entries:
                    entries[props][1:] = [int(m.group(1)), int(m.group(2))]
            elif (m := re.search(r"Used (\d+) registers", ln)) and cur:
                entries[cur][0] = int(m.group(1))
        names = list(entries)
        filt = shutil.which("c++filt") or shutil.which("cu++filt")
        if filt and names:
            out = subprocess.run([filt], input="\n".join(names), text=True,
                                 capture_output=True).stdout.splitlines()
            if len(out) == len(names):
                strip = r"^void |\(anonymous namespace\)::|\(.*\)$"
                names = [re.sub(strip, "", n) for n in out]
        parts = [f"{n} {r} registers, spill {st}/{ld} bytes"
                 for n, (r, st, ld) in zip(names, entries.values())]
        lines.append(f"ptxas {src}: " + "; ".join(parts))
    return lines


def time_ms(fn, flush, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` launches, each timed with CUDA
    events after a write of `flush` (larger than the 50 MB L2) so every
    launch finds its weights cold, as the decode loop does. A ~1 ms device
    spin before the start event keeps the card busy while the host enqueues
    fn(), so the host's launch overhead stays out of the reading."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bf16_ulp(v):
    import torch

    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


def kernel_module(name):
    import importlib

    return importlib.import_module(f"{PKG}.kernels.{KERNELS[name][0]}")


def reset_launches():
    for name in KERNELS:
        setattr(kernel_module(name), KERNELS[name][1], 0)


def read_launches() -> dict:
    return {name: getattr(kernel_module(name), KERNELS[name][1])
            for name in KERNELS}


def digest(*ts) -> str:
    """The first 16 hex digits of a sha256 over the tensors' bytes: two
    trees' kernels on the same inputs are bit-equal where these agree."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def rows_rel(a, b):
    """Each row's relative error ||a - b|| / ||b||."""
    return (a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)


def row_rel(a, b) -> float:
    """Row-wise relative error, the worst row."""
    return float(rows_rel(a, b).max())


def entry(err, ms, pms, nbytes, flops, peak="bf16", library_ms=None) -> dict:
    """A kernel's row: its numbers, and its bound at the row's shape: the
    larger of the bytes it must move (each input read once, each output
    written once) over the H100 SXM's 3.35 TB/s and its operations over the
    data-sheet peak of their type (bf16 989 TFLOP/s, int8 1,979 TOP/s, f32
    67). `flops` is a count of `peak`'s type, or {type: count}."""
    from physics_llm_inference_tpu_torch.specs.gpu import H100_SXM as spec

    t_bytes = nbytes / spec.hbm_bandwidth * 1e3
    rate = {"bf16": spec.peak_flops, "int8": spec.peak_int8_ops,
            "fp32": spec.fp32_tflops * 1e12}
    ops = flops if isinstance(flops, dict) else {peak: flops}
    t_ops = sum(n / rate[kind] for kind, n in ops.items()) * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def int8pack_ms(x, wq, s, want, flush, reps: int = 20):
    """Time of torch._weight_int8pack_mm (x @ w.T * scales, w (N, K) int8)
    on the same function, or None where the installed torch does not run it
    on CUDA or it disagrees with the plain version."""
    import torch

    wt, sc = wq.t().contiguous(), s.reshape(-1).to(x.dtype)
    try:
        got = torch._weight_int8pack_mm(x, wt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        log(f"torch._weight_int8pack_mm not run on CUDA: "
            f"{str(e).splitlines()[0][:120]}")
        return None
    rel = row_rel(got.float(), want)
    if rel > 2e-2:
        log(f"torch._weight_int8pack_mm disagrees (row-wise {rel:.3g})")
        return None
    return time_ms(lambda: torch._weight_int8pack_mm(x, wt, sc), flush, reps,
                   warmup=1)


# K1's shapes: the 7B block linears (K, N) at the rows the main paths give
# them: M = 64, a decode step's batch, then the serving engine's prefill
# dispatches (R chunks of up to 512 tokens, R a power of two) below the
# 2,048 rows from which models/transformer._linear takes a library GEMM
K1_ROWS = (64, 128, 256, 512, 1024, 2047)


def k1_linears() -> dict:
    d, f = WIDTHS["hidden_dim"], WIDTHS["intermediate_dim"]
    hd = d // WIDTHS["num_heads"]
    return {"wqkv": (d, (WIDTHS["num_heads"] + 2 * WIDTHS["num_kv_heads"])
                     * hd), "wo": (d, d), "w_gate_up": (d, 2 * f),
            "w_down": (f, d)}


def k1_case(km, x, wq, s, route, what: str):
    """One K1 launch on `route` against the plain version: rtol 1e-2
    (another f32 summation order, then one bf16 round) plus 1e-3 of the
    output's max (entries that cancel to ~0); a second launch must give the
    same bits (fixed-order sums), and the entry point too where the rule
    picks `route`. Returns (max abs err, the plain output)."""
    import torch

    got = km._launch(route, x, wq[1], s[1])
    again = km._launch(route, x, wq[1], s[1])
    want = km.int8_matmul_plain(x, wq, s, layer=1).float()
    m, k = x.shape
    entry_point = (km.int8_matmul(x, wq, s, layer=1)
                   if km.pick_route(m, wq.shape[-1], k) == route else got)
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    bound = 1e-2 * want.abs() + 1e-3 * float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(f"K1 {what}: max err {float(err.max()):.4g} "
                             "exceeds rtol 1e-2 + 1e-3 of the max")
    if not (torch.equal(got, again) and torch.equal(got, entry_point)):
        raise AssertionError(f"K1 {what}: two launches differ")
    return float(err.max()), want


def check_k1(dev, flush, g) -> dict:
    """K1 at every (linear, M) of K1_ROWS and the lm_head at M = 64 (plus a
    ragged M), on each route the wrapper has (each checked, bit-equal twice,
    timed), beside the bound, torch._weight_int8pack_mm (the library call
    computing the same function) and, from M = 128, torch.mm of x with the
    weights cast to bf16 (f32 output: what _linear_f32 runs from 2,048
    rows; a GEMM-only yardstick, never called by the port for K1). Returns
    the entries of the four linears at M = 64 (int8_matmul) and of gate/up
    at M = 512 (int8_matmul_prefill)."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import int8_matmul as km
    from physics_llm_inference_tpu_torch.kernels.w8a16_stream import plan

    out, layer64 = {}, {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0,
                        "flops": 0, "err": 0.0}
    shapes = [(name, m, k, n) for m in K1_ROWS
              for name, (k, n) in k1_linears().items()]
    shapes.insert(4, ("lm_head", 64, WIDTHS["hidden_dim"],
                      WIDTHS["vocab_size"]))
    shapes.insert(5, ("ragged", 7, WIDTHS["hidden_dim"],
                      k1_linears()["wqkv"][1] + 64))
    per_m = {}
    for name, m, k, n in shapes:
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        wq = torch.randint(-127, 128, (2, k, n), dtype=torch.int8,
                           generator=g, device=dev)
        s = torch.rand((2, 1, n), generator=g, device=dev) * 2 / (73.9 * k ** 0.5)
        wbytes = nbytes(x, wq[1], s[1]) + m * n * 2
        flops = 2 * m * k * n
        bound = entry(0.0, 0.0, 0.0, wbytes, flops)
        parts, times, err = [], {}, 0.0
        for r in km.ROUTES:
            e, want = k1_case(km, x, wq, s, r, f"{name} ({m},{k},{n}) {r}")
            err = max(err, e)
            ms = time_ms(lambda: km._launch(r, x, wq[1], s[1]), flush)
            times[r] = ms
            stage = ""
            if r == "stream":   # the ring's us a stage on one SM
                pl = plan(m, n, k, km.num_sms(dev))
                stage = f", {ms * 1e3 * pl.blocks / pl.tiles:.2f} us a stage"
            parts.append(f"{r} {ms:.4f} ms ({flops / ms / 1e9:.1f}"
                         f" TFLOP/s, {k * n / ms / 1e6:.0f} GB/s of weights"
                         f"{stage})")
        chosen = km.pick_route(m, n, k)
        ms = times[chosen]
        lib = int8pack_ms(x, wq[1], s[1], want, flush, reps=5)
        mm = None
        if m >= 128:
            wb = wq[1].bfloat16()
            mm = time_ms(lambda: torch.mm(x, wb, out_dtype=torch.float32),
                         flush)
            del wb
        log(f"K1 {name:9s} M={m} K={k} N={n}: {'; '.join(parts)}"
            f", rule -> {chosen}; max_abs_err "
            f"{err:.4g}; bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']}); torch._weight_int8pack_mm "
            f"{'none' if lib is None else f'{lib:.4f} ms'}"
            + ("" if mm is None else f"; torch.mm bf16 (f32 out) {mm:.4f} ms "
               f"({flops / mm / 1e9:.1f} TFLOP/s)"))
        if name in k1_linears():
            acc = per_m.setdefault(m, {"ms": 0.0, "bound": 0.0, "lib": 0.0,
                                       "mm": 0.0,
                                       **{r: 0.0 for r in km.ROUTES}})
            acc["ms"] += ms
            acc["bound"] += bound["bound_ms"]
            acc["lib"] = None if lib is None or acc["lib"] is None \
                else acc["lib"] + lib
            acc["mm"] += mm or 0.0
            for r in km.ROUTES:
                acc[r] += times[r]
        if m == 64 and name in k1_linears():
            layer64["ms"] += ms
            layer64["plain"] += time_ms(
                lambda: km.int8_matmul_plain(x, wq, s, layer=1), flush)
            layer64["lib"] = None if lib is None or layer64["lib"] is None \
                else layer64["lib"] + lib
            layer64["bytes"] += wbytes
            layer64["flops"] += flops
            layer64["err"] = max(layer64["err"], err)
        if m == 512 and name == "w_gate_up":
            out["int8_matmul_prefill"] = entry(
                err, ms, time_ms(lambda: km.int8_matmul_plain(
                    x, wq, s, layer=1), flush, reps=5), wbytes, flops,
                library_ms=lib)
        del x, wq, s, want
    for m, acc in per_m.items():
        lib = acc["lib"]
        log(f"K1 the four linears at M={m}: kernel {acc['ms']:.4f} ms"
            + "".join(f", {r} {acc[r]:.4f}" for r in km.ROUTES)
            + f"; bound {acc['bound']:.4f} ms; torch._weight_int8pack_mm "
            f"{'none' if lib is None else f'{lib:.4f} ms'}"
            + (f"; torch.mm bf16 {acc['mm']:.4f} ms" if m >= 128 else ""))
    torch.cuda.empty_cache()
    return {"int8_matmul": entry(layer64["err"], layer64["ms"],
                                 layer64["plain"], layer64["bytes"],
                                 layer64["flops"], library_ms=layer64["lib"]),
            **out}


def check_kernels(dev, flush) -> dict:
    """Phase 3. Returns {kernel: entry}."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    out.update(check_k1(dev, flush, g))

    out["int8_kv_decode_attention"] = check_k2(dev, flush, g)
    out["lmhead_greedy"] = check_k3(dev, flush, g)
    for mode, (_, _, name, _) in FUSED_MODES.items():
        out[name] = check_fused(dev, flush, mode)[0]
    fused_seeds(dev, flush)
    check_fused_capture(dev)
    out["flash_attention"] = check_flash(dev, flush)
    out.update(check_paged_attention(dev, flush))
    out["fused_paged_decode_step"] = check_fused_paged(dev, flush)
    out.update(check_teaching(dev, flush))
    return out


def check_k2(dev, flush, g) -> dict:
    """K2 at B = 64, Hq 32, Hkv 8, d 128 over a 2-layer cache with ragged
    ranges (q_slot in [S/2, S), valid_from in [0, S/2)), at S = 256 (the
    per-op path's cache: prompt 128 + 128 tokens), 1,024 and 4,096: held
    against its plain version, two launches bit-equal, timed with the GB/s
    of live KV. Returns the entry at S = 256."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import int8_kv_attention as ka

    hq, hkv = WIDTHS["num_heads"], WIDTHS["num_kv_heads"]
    hd = WIDTHS["hidden_dim"] // hq
    L, B = 2, 64
    g_long = torch.Generator(device=dev).manual_seed(SEED + 10)
    for S in (256, 1024, 4096):
        gen = g if S == 256 else g_long   # S = 256 draws what it always drew
        q = torch.randn((B, hq, hd), generator=gen, device=dev).bfloat16()
        kq, vq = (torch.randint(-127, 128, (L, B, S, hkv * hd),
                                dtype=torch.int8, generator=gen, device=dev)
                  for _ in "kv")
        ks, vs = (torch.rand((L, B, hkv, S), generator=gen, device=dev) * 0.03
                  for _ in "kv")
        qslot = torch.randint(S // 2, S, (B,), generator=gen, device=dev).int()
        vfrom = torch.randint(0, S // 2, (B,), generator=gen, device=dev).int()
        args = (q, kq, ks, vq, vs, qslot, vfrom)
        got = ka.int8_kv_decode_attention(*args, layer=1).float()
        want = ka.int8_kv_decode_attention_plain(*args, layer=1).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not bool(torch.isfinite(got).all()) or err > 2e-2:
            raise AssertionError(f"K2 S={S}: max abs err {err:.4g} > 2e-2")
        if not torch.equal(ka.int8_kv_decode_attention(*args, layer=1).float(),
                           got):
            raise AssertionError(f"K2 S={S}: two launches differ")
        ms = time_ms(lambda: ka.int8_kv_decode_attention(*args, layer=1),
                     flush)
        pms = time_ms(lambda: ka.int8_kv_decode_attention_plain(
            *args, layer=1), flush, reps=5 if S > 256 else 20)
        keys = int((qslot - vfrom + 1).sum())  # live keys, one layer
        live = keys * hkv * hd * 2
        log(f"K2 int8_kv_decode_attention B={B} S={S} Hq={hq} Hkv={hkv} "
            f"d={hd}: max_abs_err {err:.4g} (atol 2e-2), two launches "
            f"bit-equal, kernel {ms:.4f} ms ({live / ms / 1e6:.0f} GB/s of "
            f"live KV), plain {pms:.4f} ms")
        if S == 256:
            row = entry(err, ms, pms, keys * hkv * (2 * hd + 2 * 4)
                        + 2 * nbytes(q) + nbytes(qslot, vfrom),
                        4 * hq * hd * keys)
        del kq, vq, ks, vs
    return row


def check_k3(dev, flush, g) -> dict:
    """K3 at B=64, D=4096, V=32000 against the plain version, timed; returns
    its entry."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import int8_matmul as km
    from physics_llm_inference_tpu_torch.kernels import lmhead as kh
    from physics_llm_inference_tpu_torch.ops.norms import rms_norm

    d, v = WIDTHS["hidden_dim"], WIDTHS["vocab_size"]
    # K3 at B=64, D=4096, V=32000: the kernel's token must carry a plain
    # logit within one bf16 ulp of the plain row maximum
    x = torch.randn((64, d), generator=g, device=dev).bfloat16()
    nw = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).bfloat16()
    lq = torch.randint(-127, 128, (d, v), dtype=torch.int8, generator=g,
                       device=dev)
    ls = torch.rand((1, v), generator=g, device=dev) * 2 / (73.9 * d ** 0.5)
    tok = kh.lmhead_greedy(x, nw, lq, ls, eps=1e-6).long()
    ptok = kh.lmhead_greedy_plain(x, nw, lq, ls, eps=1e-6).long()
    logits = km.int8_matmul_plain(rms_norm(x, nw, 1e-6), lq, ls,
                                  out_dtype=torch.float32)
    logits = logits.bfloat16().float()
    top = logits.max(dim=-1).values
    gap = top - logits.gather(1, tok[:, None])[:, 0]
    if bool((gap > bf16_ulp(top)).any()):
        raise AssertionError(f"K3: token logit {float(gap.max()):.4g} below "
                             "the row max, more than one bf16 ulp")
    err = float(gap.max())
    ms = time_ms(lambda: kh.lmhead_greedy(x, nw, lq, ls, eps=1e-6), flush)
    pms = time_ms(lambda: kh.lmhead_greedy_plain(x, nw, lq, ls, eps=1e-6),
                  flush)
    same = int((tok == ptok).sum())
    log(f"K3 lmhead_greedy B=64 D={d} V={v}: {same}/64 tokens equal to plain, "
        f"max gap to the row max {err:.4g} (<= 1 bf16 ulp), kernel "
        f"{ms:.4f} ms ({d * v / ms / 1e6:.0f} GB/s of head), plain {pms:.4f} ms")
    return entry(err, ms, pms, nbytes(x, nw, lq, ls, tok.int()),
                 2 * 64 * d * v)


def fused_bound(blocks, x, L, hkv, hd, hq, read_keys, written,
                act_quant="none"):
    """(bytes, {type: operations}) of one fused decode step: every weight
    (INT4: the packed codes), scale (INT4: the group scales) and norm once,
    the live K/V codes and scales read, the new ones written, x in and out.
    The block matmuls count K·N multiply-adds a row whatever the packing,
    in int8 under W8A8 and bf16 otherwise; attention is bf16."""
    from physics_llm_inference_tpu_torch.models.quant import QuantizedTensor4

    wts = [blocks[n] for n in ("wqkv", "wo", "w_gate_up", "w_down")]
    weights = sum(nbytes(w.q, w.s) for w in wts) + nbytes(blocks["ln1"],
                                                          blocks["ln2"])
    per_key = L * hkv * (2 * hd + 2 * 4)
    macs = sum(w.q[0].numel() * (2 if isinstance(w, QuantizedTensor4) else 1)
               for w in wts)
    matmul = 2 * x.shape[0] * macs * L
    attn = 4 * hq * hd * L * (read_keys + written)
    ops = ({"int8": matmul, "bf16": attn} if act_quant == "int8"
           else {"bf16": matmul + attn})
    return weights + per_key * (read_keys + written) + 2 * nbytes(x), ops


# W8A8's rules for a row-wise comparison of the kernel with the plain
# version, each a (median row, worst row) limit on rows_rel. The kernel's
# attention (an online softmax over key tiles) and the plain version's (one
# softmax over all keys) round p * v_scale to bf16 apart. A bf16 attention
# value that rounds apart can flip its int8 activation code, and a flipped
# row maximum moves every code of its row, so single rows move by a few
# percent: W8A8_TILED. Where no cached key is live, attention is the current
# token's V in both versions, every product is exact in int32 and the norms
# are correctly rounded, so most rows agree to the last bits; a code that
# rounds apart at a near-tie in layer 0 still moves its row by up to ~1%
# through layer 1's quantizers: W8A8_OWN_TOKEN. Each rule is checked against
# controls, the plain version with one of its four activation quantization
# points left out, which a sound rule must refuse.
W8A8_TILED, W8A8_OWN_TOKEN = (2e-2, 1e-1), (1e-4, 2e-2)
QUANT_POINTS = ("ln1", "attention", "ln2", "silu")


def w8a8_rows_ok(rel, controls: dict, what: str, rule=W8A8_TILED) -> str:
    """Hold `rel` (rows_rel of the kernel against the plain version) to
    `rule`, and every control ({point: rows_rel of the plain version
    without that quantization point, against the same plain run}) to
    failing it. Returns the readings."""
    import torch

    said = f"median <= {rule[0]:g}, worst <= {rule[1]:g}"

    def passes(r):
        return (bool(torch.isfinite(r).all()) and float(r.median()) <= rule[0]
                and float(r.max()) <= rule[1])

    def reading(r):
        return f"median {float(r.median()):.4g}, worst {float(r.max()):.4g}"

    if not passes(rel):
        raise AssertionError(f"{what}: {reading(rel)}, outside {said}")
    for point, r in controls.items():
        if passes(r):
            raise AssertionError(
                f"{what}: the control without the {point} quantization "
                f"passes {said} too ({reading(r)}): the rule cannot tell a "
                "kernel that skips it")
    return (f"{reading(rel)} ({said}); controls without a quantization "
            "point: " + ", ".join(f"{p} {reading(r)}"
                                  for p, r in controls.items()))


class quant_point_off:
    """The plain fused step with one W8A8 activation quantization point
    (QUANT_POINTS) left out: that point's f32 row goes into its product
    unquantized. fused_decode_step_plain quantizes, in each layer, the ln1
    row, k, v, the attention row, the ln2 row and the silu row, in that
    order; a run that makes another number of calls raises."""

    def __init__(self, point: str, layers: int):
        self.at = {"ln1": 0, "attention": 3, "ln2": 4, "silu": 5}[point]
        self.layers = layers
        self.kf = kernel_module("fused_decode_step")

    def __enter__(self):
        import torch

        quant = self.quant = self.kf._quant
        self.calls = 0

        def off(t):
            at, self.calls = self.calls % 6, self.calls + 1
            if at == self.at:
                return t.float(), torch.ones_like(t[..., :1], dtype=torch.float32)
            return quant(t)

        self.kf._quant = off

    def __exit__(self, *exc):
        self.kf._quant = self.quant
        if exc[0] is None and self.calls != 6 * self.layers:
            raise AssertionError(f"quant_point_off: {self.calls} quantizer "
                                 f"calls, expected {6 * self.layers}")


def w8a8_controls(run, want, layers: int) -> dict:
    """{point: rows_rel(run() without that quantization point, want)}."""
    out = {}
    for point in QUANT_POINTS:
        with quant_point_off(point, layers):
            out[point] = rows_rel(run(), want)
    return out


# K4 W4A16's rule. Its random INT4 weights (uniform nibbles, mean -0.5)
# make the residual stream large and uneven: at 2 layers the median x_out
# row norm is ~3.7e4 (~60 in W8A16), and a few rows cancel to 30-500x below
# it, which multiplies their error relative to their own norm. The kernel's
# layer-0 K/V codes equal the plain version's, and with no cached key live
# the two agree within ~0.2% over two layers; it departs where its tiled
# softmax rounds p * v_scale to bf16 against another running max than the
# plain one-pass softmax. Two bf16 roundings of one value at two scales
# differ by up to one ulp, twice the half ulp between one rounding and the
# value itself; to first order a row's x_out moves linearly with those
# per-element differences, so its expected move is at most twice the move
# of the plain version with p * v_scale left unrounded (the reference's
# spread at the point where the kernel departs). Both are taken at the same
# row relative to its own norm, so the row's cancellation multiplies both
# alike. Each row's error relative to its own norm is held to the larger
# of 2e-2 and twice that row's spread. A fixed 2e-2 of the row's own norm
# failed at random seeds (0.11, 0.73, 0.21 at seeds 102, 302, 402) where the
# spread was as large. Each control, the plain version with a defect a W4A16
# kernel could have, must break the rule on some row: three gross ones
# (nibble order, Q rotation, the first live key left out) and two single
# bf16 roundings the plain version does not make (the cached keys' q . k,
# and the P @ V sum over them before the division).
W4A16_RULE = 2e-2
W4A16_CONTROLS = ("nibble order", "Q rotation", "first key", "bf16 q.k",
                  "bf16 P@V")


class w4a16_variant:
    """The plain fused step changed at one point: "unrounded p*v" keeps
    p * v_scale in f32 (the spread of W4A16's rule); the defects "nibble
    order" (each packed byte's high nibble read as the low one's channel
    and the low as the high one's), "Q rotation" (the queries left
    unrotated; fused_decode_step_plain rotates q, then k, in each layer),
    "bf16 q.k" (the cached keys' scores rounded to bf16 before their scale)
    and "bf16 P@V" (the P @ V sum over the cached keys rounded to bf16
    before the current token's term and the division). The last two round
    the result of one einsum of fused_decode_step_plain, which it makes
    once a layer; a run that makes another number raises."""

    EINSUMS = {"bf16 q.k": "bhgd,bshd->bhgs", "bf16 P@V": "bhgs,bshd->bhgd"}

    def __init__(self, variant: str, layers: int):
        self.variant, self.layers = variant, layers
        self.kf = kernel_module("fused_decode_step")

    def __enter__(self):
        import torch

        kf = self.kf
        self.saved = kf.unpack_int4, kf._rope, kf._round_pv, torch.einsum
        unpack, rope, _, einsum = self.saved
        calls = [0]
        self.calls = calls

        def swapped(q):
            lo, hi = unpack(q).chunk(2, dim=-1)
            return torch.cat([hi, lo], dim=-1)

        def unrotated_q(x, cos, sin):
            calls[0] += 1
            return x if calls[0] % 2 == 1 else rope(x, cos, sin)

        def rounded(spec, *ops):
            out = einsum(spec, *ops)
            if spec != self.EINSUMS[self.variant]:
                return out
            calls[0] += 1
            return out.to(torch.bfloat16).float()

        if self.variant == "nibble order":
            kf.unpack_int4 = swapped
        elif self.variant == "Q rotation":
            kf._rope = unrotated_q
        elif self.variant in self.EINSUMS:
            torch.einsum = rounded
        else:
            kf._round_pv = lambda pv: pv

    def __exit__(self, *exc):
        import torch

        (self.kf.unpack_int4, self.kf._rope, self.kf._round_pv,
         torch.einsum) = self.saved
        if (exc[0] is None and self.variant in self.EINSUMS
                and self.calls[0] != self.layers):
            raise AssertionError(f"w4a16_variant {self.variant!r}: "
                                 f"{self.calls[0]} rounded einsums, expected "
                                 f"{self.layers}")


def check_w4a16_rows(blocks, x, cache, args, kw, got, want, what) -> str:
    """Hold K4 W4A16's x_out to its rule (W4A16_RULE), each row relative to
    its own norm, and every control of W4A16_CONTROLS to breaking it.
    Returns the readings: the worst row's error over its bound, and each
    control's worst row over its bound."""
    import torch

    kf = kernel_module("fused_decode_step")
    layers = args[-1].num_layers

    def plain(args_=args):
        c = [t.clone() for t in cache]
        return kf.fused_decode_step_plain(blocks, x, *c, *args_,
                                          **kw)[0].float()

    err = rows_rel(got, want)
    with w4a16_variant("unrounded p*v", layers):
        spread = rows_rel(plain(), want)
    bound = (2 * spread).clamp_min(W4A16_RULE)
    controls = {}
    for name in W4A16_CONTROLS:
        if name == "first key":
            qslot, vfrom = args[0], args[1]
            controls[name] = rows_rel(
                plain((qslot, (vfrom + 1).minimum(qslot), *args[2:])), want)
        else:
            with w4a16_variant(name, layers):
                controls[name] = rows_rel(plain(), want)
    ratio = err / bound
    r = int(ratio.argmax())
    said = (f"worst row {r}: {float(err[r]):.4g} of its own norm "
            f"({float(want[r].norm()):.4g}, median "
            f"{float(want.norm(dim=-1).median()):.4g}), {float(ratio[r]):.3f} "
            f"of its bound {float(bound[r]):.4g} (2e-2, or twice its spread "
            f"with p * v_scale unrounded; the spread reads up to "
            f"{float(spread.max()):.4g}); controls, worst row over its bound: "
            + ", ".join(f"{n} {float((c / bound).max()):.3g}"
                        for n, c in controls.items()))
    if not bool(torch.isfinite(err).all()) or float(ratio[r]) > 1:
        raise AssertionError(f"{what}: outside the rule; {said}")
    for name, c in controls.items():
        if not bool((c > bound).any()):
            raise AssertionError(f"{what}: the control {name!r} keeps every "
                                 f"row within its bound too; {said}")
    return said


def slot_codes(got_c, want_c, slot: int, what: str, deep: bool = True,
               strict: int = 1) -> list:
    """The new K/V codes at `slot` of the kernel's cache against the plain
    version's. The first `strict` layers: within one level, >= 99.9% equal
    (layer 0 sees the same input, but the kernel's f32 sums, in WMMA tiles
    and k-splits, and the plain version's run in other orders, so a bf16
    rounding of qkv can flip); with `deep`, the later ones within one level
    on >= 99%. Returns the readings, with the scales' relative error."""
    notes = []
    for i, name in ((0, "k"), (2, "v")):
        d = (got_c[i][:, :, slot].int() - want_c[i][:, :, slot].int()).abs()
        eq = float((d[:strict] == 0).float().mean())
        if int(d[:strict].max()) > 1 or eq < 0.999:
            raise AssertionError(f"{what}: {name} codes of layers < {strict}: "
                                 f"max diff {int(d[:strict].max())}, equal "
                                 f"{eq:.5f}")
        note = f"{name} codes of layers < {strict} equal {eq:.5f}"
        if deep and strict < d.shape[0]:
            near = float((d[strict:] <= 1).float().mean())
            if near < 0.99:
                raise AssertionError(f"{what}: {name} codes of deeper layers "
                                     f"within one level {near:.5f}")
            note += f", deeper within one level {near:.5f}"
        notes.append(note)
    for i in (1, 3):
        sr = ((got_c[i][..., slot] - want_c[i][..., slot]).abs()
              / want_c[i][..., slot].abs()).max()
        notes.append(f"scale rel err {float(sr):.3g}")
    return notes


def check_w8a8_exact(blocks, x, cache, cfg, slot: int) -> str:
    """K4 W8A8 where no cached key is live (valid_from = q_slot): each row
    attends to its own token alone, so attention returns that token's V in
    both versions: the step is held to W8A8_OWN_TOKEN, the new codes of
    every layer to layer 0's rule, and the controls to failing the first."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import fused_decode as kf
    from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies

    B, dev = x.shape[0], x.device
    qslot = torch.full((B,), slot, dtype=torch.int32, device=dev)
    pos = torch.zeros(B, dtype=torch.long, device=dev)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len, device=dev)
    args = (qslot, qslot.clone(), cos[pos], sin[pos], cfg)
    kw = dict(slot=qslot, write_cache=True)
    got_c = [t.clone() for t in cache]
    want_c = [t.clone() for t in cache]
    got = kf.fused_decode_step(blocks, x, *got_c, *args, **kw)[0].float()
    want = kf.fused_decode_step_plain(blocks, x, *want_c, *args,
                                      **kw)[0].float()
    torch.cuda.synchronize()

    def plain():
        return kf.fused_decode_step_plain(
            blocks, x, *[t.clone() for t in cache], *args, **kw)[0].float()

    what = "K4 W8A8, no cached key"
    rows = w8a8_rows_ok(rows_rel(got, want),
                        w8a8_controls(plain, want, cfg.num_layers), what,
                        W8A8_OWN_TOKEN)
    codes = slot_codes(got_c, want_c, slot, what, strict=cfg.num_layers)
    return f"with no cached key x_out {rows}; {'; '.join(codes)}"


def check_fused(dev, flush, mode="w8a16", seed=SEED + 2, timed=True):
    """K4 in `mode` (FUSED_MODES) at the 7B widths, 2 layers, B = 64,
    S = 256, ragged valid_from, the generate path's in-place write at the
    write slots q_slot (read by the kernel from the device), on inputs made
    from `seed`. Returns (its entry (max_abs_err of x_out), timed, or None,
    and the worst row's relative error of x_out)."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import fused_decode as kf
    from physics_llm_inference_tpu_torch.models import quant
    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies

    init, act, name, _ = FUSED_MODES[mode]
    tag = "K4" if mode == "w8a16" else f"K4 {mode.upper()}"
    cfg = ModelConfig(num_layers=2, act_quant=act, **WIDTHS)
    g = torch.Generator(device=dev).manual_seed(seed)
    blocks = getattr(quant, init)(g, cfg)["blocks"]
    L, B, S, slot = 2, 64, 256, 200
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cache = []
    for _ in ("k", "v"):
        cache += [torch.randint(-127, 128, (L, B, S, hkv * hd),
                                dtype=torch.int8, generator=g, device=dev),
                  torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.03]
    x = (torch.randn((B, cfg.hidden_dim), generator=g, device=dev)
         * cfg.hidden_dim ** -0.5).bfloat16()
    qslot = torch.full((B,), slot, dtype=torch.int32, device=dev)
    vfrom = torch.randint(0, 128, (B,), generator=g, device=dev).int()
    pos = slot - vfrom
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    args = (qslot, vfrom, cos[pos], sin[pos], cfg)
    kw = dict(slot=qslot, write_cache=True)
    got_c = [t.clone() for t in cache]
    want_c = [t.clone() for t in cache]
    counter = KERNELS[name][1]
    before = getattr(kf, counter)
    got = kf.fused_decode_step(blocks, x, *got_c, *args, **kw)[0].float()
    want = kf.fused_decode_step_plain(blocks, x, *want_c, *args,
                                      **kw)[0].float()
    torch.cuda.synchronize()
    if getattr(kf, counter) != before + 1:
        raise AssertionError(f"{tag}: the launch did not go to {counter}")
    rel = row_rel(got, want)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: x_out not finite")
    if mode == "w8a8":
        def plain():
            return kf.fused_decode_step_plain(
                blocks, x, *[t.clone() for t in cache], *args, **kw)[0].float()

        rows = (w8a8_rows_ok(rows_rel(got, want), w8a8_controls(plain, want, L),
                             f"{tag} x_out")
                + "; " + check_w8a8_exact(blocks, x, cache, cfg, slot))
    elif mode == "w4a16":
        rows = check_w4a16_rows(blocks, x, cache, args, kw, got, want,
                                f"{tag} x_out")
    elif rel > 2e-2:
        raise AssertionError(f"{tag}: x_out row-wise relative error {rel:.4g} "
                             "> 2e-2")
    for i, name in enumerate(("k", "k scale", "v", "v scale")):
        a, b, c = got_c[i], want_c[i], cache[i]
        keep = torch.ones(S, dtype=torch.bool, device=dev)
        keep[slot] = False
        outside = (a[:, :, keep] if a.dtype == torch.int8
                   else a[..., keep])
        ref = c[:, :, keep] if a.dtype == torch.int8 else c[..., keep]
        if not torch.equal(outside, ref):
            raise AssertionError(f"{tag}: {name} cache changed outside the "
                                 "slot")
    # W8A8 holds its deeper layers' codes in check_w8a8_exact: here a flipped
    # activation code of layer 0 reaches them
    codes = slot_codes(got_c, want_c, slot, tag, deep=mode != "w8a8")
    # fixed-order sums, no float atomics: a second launch on the same
    # inputs gives the same bits
    again_c = [t.clone() for t in cache]
    again = kf.fused_decode_step(blocks, x, *again_c, *args, **kw)[0].float()
    if not torch.equal(again, got) or not all(
            torch.equal(a, b) for a, b in zip(again_c, got_c)):
        raise AssertionError(f"{tag}: two launches on the same inputs differ")
    err = float((got - want).abs().max())
    if not timed:
        log(f"{tag} seed {seed}: x_out row-wise rel err {rel:.4g}"
            f"{f' ({rows})' if mode != 'w8a16' else ''}; "
            f"{'; '.join(codes)}; two launches bit-equal")
        return None, rel
    ms = time_ms(lambda: kf.fused_decode_step(blocks, x, *got_c, *args, **kw),
                 flush)
    pms = time_ms(lambda: kf.fused_decode_step_plain(blocks, x, *want_c,
                                                     *args, **kw), flush)
    wbytes = sum(blocks[n].q.numel() for n in ("wqkv", "wo", "w_gate_up",
                                               "w_down"))
    live = int((qslot - vfrom).sum()) * L * hkv * hd * 2
    bound = entry(err, ms, pms, *fused_bound(
        blocks, x, L, hkv, hd, cfg.num_heads, int((qslot - vfrom).sum()), B,
        act))
    log(f"{tag} fused_decode_step 7B widths L={L} B={B} S={S}: x_out "
        f"row-wise rel err {rel:.4g} "
        f"({rows if mode != 'w8a16' else '2e-2'}), max abs {err:.4g}; "
        f"{'; '.join(codes)}; cache outside the slot unchanged; two launches "
        f"bit-equal; kernel {ms:.4f} ms "
        f"({(wbytes + live) / ms / 1e6:.0f} GB/s of weights + live KV), "
        f"plain {pms:.4f} ms, bound {bound['bound_ms']:.4f} ms; output "
        f"digest {digest(got, *got_c)}")
    return bound, rel


# the seeds K4 W8A16 and W4A16 are held at: check_fused's own and seven more
FUSED_SEEDS = tuple(SEED + 2 + 100 * i for i in range(8))


def fused_seeds(dev, flush):
    """K4 W8A16 and W4A16 under check_fused's rules at every seed of
    FUSED_SEEDS (the first is phase 3's timed run, here untimed); each
    seed's x_out row-wise error of the two modes side by side. Every seed
    runs and is logged before a seed that failed raises."""
    rels, failed = {"w8a16": [], "w4a16": []}, []
    for m in rels:
        for seed in FUSED_SEEDS:
            try:
                rel = check_fused(dev, flush, m, seed, timed=False)[1]
                rels[m].append(f"{rel:.4g}")
            except AssertionError as e:
                log(f"K4 {m.upper()} seed {seed} failed: {e}")
                rels[m].append("failed")
                failed.append(f"{m} seed {seed}")
    log("K4 x_out row-wise rel err by seed (W8A16, rule 2e-2 | W4A16, "
        "held to its rule, check_w4a16_rows): "
        + "; ".join(f"{seed}: {a} | {b}" for seed, a, b in
                    zip(FUSED_SEEDS, rels["w8a16"], rels["w4a16"])))
    if failed:
        raise AssertionError("K4 failed its rule at " + ", ".join(failed))


def check_fused_capture(dev):
    """K4 W8A16 (7B widths, 2 layers, B 8) captured once in a CUDA graph and
    replayed at two write slots set in its static slot buffer: each replay
    bit-equal to an eager launch at that slot (x_out and the whole cache),
    and the counter moved by one launch a replay."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import fused_decode as kf
    from physics_llm_inference_tpu_torch.models import quant
    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies
    from physics_llm_inference_tpu_torch.runtime.step_cache import \
        CapturedStep

    cfg = ModelConfig(num_layers=2, **WIDTHS)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    blocks = quant.init_params_int8(g, cfg)["blocks"]
    L, B, S = 2, 8, 256
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cache = []
    for _ in ("k", "v"):
        cache += [torch.randint(-127, 128, (L, B, S, hkv * hd),
                                dtype=torch.int8, generator=g, device=dev),
                  torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.03]
    x = (torch.randn((B, cfg.hidden_dim), generator=g, device=dev)
         * cfg.hidden_dim ** -0.5).bfloat16()
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    slot = torch.zeros(B, dtype=torch.int32, device=dev)
    vfrom = torch.zeros(B, dtype=torch.int32, device=dev)
    pos = torch.zeros(B, dtype=torch.long, device=dev)
    graph_c = [t.clone() for t in cache]

    def step():
        return kf.fused_decode_step(blocks, x, *graph_c, slot, vfrom,
                                    cos[pos], sin[pos], cfg, slot=slot,
                                    write_cache=True)[0]

    captured = CapturedStep(step, dev)
    for at in (120, 121):
        graph_c[:] = [t.copy_(c) for t, c in zip(graph_c, cache)]
        slot.fill_(at)
        pos.fill_(at)
        before = kf.launches
        got = captured().clone()
        eager_c = [t.clone() for t in cache]
        want = kf.fused_decode_step(blocks, x, *eager_c, slot, vfrom,
                                    cos[pos], sin[pos], cfg, slot=slot,
                                    write_cache=True)[0]
        torch.cuda.synchronize()
        if kf.launches != before + 2:
            raise AssertionError("K4 replay: the launch counter moved by "
                                 f"{kf.launches - before - 1}, not 1")
        if not torch.equal(got, want) or not all(
                torch.equal(a, b) for a, b in zip(graph_c, eager_c)):
            raise AssertionError(f"K4 replay at slot {at}: not bit-equal to "
                                 "an eager launch")
        if torch.equal(graph_c[0][:, :, at], cache[0][:, :, at]):
            raise AssertionError(f"K4 replay: nothing written at slot {at}")
    log("K4 W8A16 captured once, replayed at slots 120 and 121: x_out and "
        "cache bit-equal to eager launches, one launch counted a replay")


def clock_reading(kf, clock, blocks, L: int, mode: int):
    """Each phase's mean us a layer from a phase_clock buffer, and for the
    GEMM phases the GB/s of that layer's weights (codes and scales): the
    line, and {phase: us a layer}."""
    names = kf.PHASES_W8A8 if mode == kf.W8A8 else kf.PHASES
    t = clock.cpu().double()
    if bool((t[1:] <= t[:-1]).any()):
        raise AssertionError("phase clock: stamps not increasing")
    dt = (t[1:] - t[:-1]).reshape(L, len(names)) / 1e3   # us
    parts, by_phase = [], {}
    for i, name in enumerate(names):
        us = by_phase[name] = float(dt[:, i].mean())
        part = f"{name} {us:.2f}"
        if name in kf.GEMM_PHASES:
            w = blocks[kf.GEMM_PHASES[name]]
            gb = nbytes(w.q, w.s) / L / 1e9
            part += f" ({gb / us * 1e6:.0f} GB/s)"
        parts.append(part)
    return (f"{float(dt.sum()) / L:.2f} us a layer, {float(dt.sum()) / 1e3:.3f}"
            f" ms in all; us a layer: " + ", ".join(parts)), by_phase


def phase_clock(dev):
    """Phase 3b: one clocked launch of each K4 mode at 32 layers, B 64, S
    256 (as check_fused, deeper), then of K8 at 32 layers in the engine's
    geometry (B 64, BS 512, MB 2, NB 161) on the W8A16 weights. Each
    follows an unclocked warm-up launch; no clocked launch is timed."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import fused_decode as kf
    from physics_llm_inference_tpu_torch.models import quant
    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies

    L, B, S, slot = 32, 64, 256, 200
    cfg = ModelConfig(num_layers=L, **WIDTHS)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    x = (torch.randn((B, cfg.hidden_dim), generator=g, device=dev)
         * cfg.hidden_dim ** -0.5).bfloat16()
    cache = []
    for _ in ("k", "v"):
        cache += [torch.randint(-127, 128, (L, B, S, hkv * hd),
                                dtype=torch.int8, generator=g, device=dev),
                  torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.03]
    qslot = torch.full((B,), slot, dtype=torch.int32, device=dev)
    vfrom = torch.randint(0, 128, (B,), generator=g, device=dev).int()
    pos = slot - vfrom
    # the attention phase reads each live cached key's K/V codes and scales
    kv_bytes = int((slot - vfrom).sum()) * hkv * (2 * hd + 8)
    attention = []
    weights = {}
    for mode, (init, act, _, _) in FUSED_MODES.items():
        mcfg = ModelConfig(num_layers=L, act_quant=act, **WIDTHS)
        if init not in weights:
            weights[init] = getattr(quant, init)(
                torch.Generator(device=dev).manual_seed(SEED), mcfg)["blocks"]
        blocks = weights[init]
        args = (qslot, vfrom, cos[pos], sin[pos], mcfg)
        kmode = kf.fused_decode_mode(blocks, mcfg)
        clock = kf.phase_clock(L, kmode, dev)
        kf.fused_decode_step(blocks, x, *cache, *args)
        kf.fused_decode_step(blocks, x, *cache, *args, clock=clock)
        torch.cuda.synchronize()
        line, us = clock_reading(kf, clock, blocks, L, kmode)
        log(f"phase clock, K4 {mode.upper()} L={L} B={B} S={S}: {line}")
        attention.append(f"K4 {mode.upper()} {us['attention']:.2f} "
                         f"({kv_bytes / us['attention'] / 1e3:.0f} GB/s)")
    blocks = weights.pop("init_params_int8")
    del cache, weights
    torch.cuda.empty_cache()
    BS, MB, NB = 512, 2, 161
    lens = torch.randint(1, MB * BS, (B,), generator=g, device=dev)
    tables = _scattered_tables(g, dev, B, MB, NB, lens // BS + 1, NB - 1)
    kv = torch.randint(-127, 128, (L, NB, 2, BS, hkv * hd), dtype=torch.int8,
                       generator=g, device=dev)
    kvs = torch.rand((L, NB, 2, hkv, BS), generator=g, device=dev) * 0.03
    args = (tables, lens.int(), cos[lens], sin[lens], cfg)
    clock = kf.phase_clock(L, kf.W8A16, dev)
    kf.fused_paged_decode_step(blocks, x, kv, kvs, *args, inplace=True)
    kf.fused_paged_decode_step(blocks, x, kv, kvs, *args, inplace=True,
                               clock=clock)
    torch.cuda.synchronize()
    line, us = clock_reading(kf, clock, blocks, L, kf.W8A16)
    log(f"phase clock, K8 L={L} B={B} BS={BS} MB={MB} NB={NB}: {line}")
    kv_bytes = int(lens.sum()) * hkv * (2 * hd + 8)
    attention.append(f"K8 {us['attention']:.2f} "
                     f"({kv_bytes / us['attention'] / 1e3:.0f} GB/s)")
    log("phase clock, attention phase, us a layer (GB/s of live KV codes "
        "and scales): " + ", ".join(attention))
    del kv, kvs, blocks
    torch.cuda.empty_cache()


def check_flash(dev, flush):
    """K5 at B = 64, Hq = 32, Hkv = 8, d = 128: square Sq = Sk = 512 and the
    rectangular Sq = 128, q_offset = 512, Sk = 640, ragged valid_from; then
    where the design can break (flash_cases); then the sweep. Returns the
    square case's entry (max_abs_err on live rows), with the time of
    scaled_dot_product_attention(attn_mask=K5's mask, enable_gqa=True) as
    its library call."""
    import torch

    import torch.nn.functional as F

    from physics_llm_inference_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    B, hq, hkv, d = 64, 32, 8, 128
    first = None
    for sq, sk, qoff in ((512, 512, 0), (128, 640, 512)):
        q = torch.randn((B, sq, hq, d), generator=g, device=dev).bfloat16()
        k = torch.randn((B, sk, hkv, d), generator=g, device=dev).bfloat16()
        v = torch.randn((B, sk, hkv, d), generator=g, device=dev).bfloat16()
        vfrom = torch.randint(0, 384, (B,), generator=g, device=dev).int()
        # (B, S, H, d) views, as block_forward hands them over
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        kw = dict(q_offset=qoff, causal=True, valid_from=vfrom)
        err = flash_err(kfa, args, kw, f"Sq={sq} Sk={sk}")
        ms = time_ms(lambda: kfa.flash_attention(*args, **kw), flush)
        pms = time_ms(lambda: kfa.flash_attention_plain(*args, **kw), flush,
                      reps=5, warmup=1)
        qpos = qoff + torch.arange(sq, device=dev)
        pairs = (qpos[None, :] - vfrom[:, None] + 1).clamp_min(0).sum()
        flop = 4 * d * hq * int(pairs)
        kpos = torch.arange(sk, device=dev)
        mask = ((kpos[None, None, :] <= qpos[None, :, None])
                & (kpos[None, None, :] >= vfrom[:, None, None]))[:, None]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            *args, attn_mask=mask, enable_gqa=True), flush)
        # the same call on K/V expanded to the query heads outside the
        # timed region, where the memory-efficient backend takes the mask
        kx, vx = (t.repeat_interleave(hq // hkv, dim=1) for t in args[1:])
        lib_x = time_ms(lambda: F.scaled_dot_product_attention(
            args[0], kx, vx, attn_mask=mask), flush)
        del kx, vx
        log(f"K5 flash_attention B={B} Hq={hq} Hkv={hkv} d={d} Sq={sq} "
            f"Sk={sk} q_offset={qoff}, ragged valid_from: max abs err on "
            f"live rows {err:.4g} (atol 2e-2), two launches bit-equal, "
            f"kernel {ms:.4f} ms "
            f"({flop / ms / 1e9:.1f} TFLOP/s of live causal work), plain "
            f"{pms:.4f} ms; scaled_dot_product_attention(mask, enable_gqa) "
            f"{lib:.4f} ms, on K/V expanded to {hq} heads {lib_x:.4f} ms")
        first = first or entry(err, ms, pms, nbytes(q, k, v, q, vfrom), flop,
                               library_ms=lib)
    flash_cases(dev, g, flush)
    flash_sweep(dev, g, flush)
    return first


def flash_err(kfa, args, kw, what) -> float:
    """K5 against its plain version: the max abs error on live rows (a query
    at or past its request's valid_from) within 2e-2, finite everywhere, and
    a second launch bit-equal to the first."""
    import torch

    got = kfa.flash_attention(*args, **kw)
    again = kfa.flash_attention(*args, **kw)
    want = kfa.flash_attention_plain(*args, **kw).float()
    torch.cuda.synchronize()
    b, _, sq, _ = args[0].shape
    dev = got.device
    qoff = torch.as_tensor(kw.get("q_offset", 0), device=dev).reshape(-1, 1)
    vfrom = kw.get("valid_from")
    vfrom = torch.zeros(b, device=dev) if vfrom is None else vfrom
    live = (qoff + torch.arange(sq, device=dev)) >= vfrom[:, None]
    err = float((got.float() - want).abs().transpose(1, 2)[live].max())
    if not bool(torch.isfinite(got).all()) or err > 2e-2:
        raise AssertionError(f"K5 {what}: max abs err on live rows "
                             f"{err:.4g} > 2e-2")
    if not torch.equal(got, again):
        raise AssertionError(f"K5 {what}: two launches differ")
    return err


def flash_cases(dev, g, flush):
    """K5 where its design can break: the paged chunk's shape (a per-request
    q_offset tensor, Sk = MB x BS = 1024, kv_len < Sk), GQA groups 1 and 8
    (128 and 16 positions a block), head_dim 64, and an Sq that is not a
    multiple of the q tile (group 4: 32 positions)."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import flash_attention as kfa

    cases = {  # name: (B, Sq, Sk, Hq, Hkv, d, q_offset, kv_len, valid_from)
        "paged chunk": (64, 128, 1024, 32, 8, 128, "per-request", 1000, None),
        "group 1": (16, 512, 512, 8, 8, 128, 0, None, "ragged"),
        "group 8": (16, 512, 512, 32, 4, 128, 0, None, "ragged"),
        "d 64": (16, 512, 512, 32, 8, 64, 0, None, "ragged"),
        "Sq 100": (16, 100, 612, 32, 8, 128, 512, None, "ragged"),
    }
    for name, (B, sq, sk, hq, hkv, d, qoff, kv_len, vfrom) in cases.items():
        q = torch.randn((B, sq, hq, d), generator=g, device=dev).bfloat16()
        k = torch.randn((B, sk, hkv, d), generator=g, device=dev).bfloat16()
        v = torch.randn((B, sk, hkv, d), generator=g, device=dev).bfloat16()
        if qoff == "per-request":   # chunk starts; request 0's passes kv_len
            qoff = torch.randint(0, sk - sq + 1, (B,), generator=g,
                                 device=dev).int()
            qoff[0] = sk - sq
        if vfrom == "ragged":
            vfrom = torch.randint(0, min(sq, 384), (B,), generator=g,
                                  device=dev).int()
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        kw = dict(q_offset=qoff, causal=True, kv_len=kv_len, valid_from=vfrom)
        err = flash_err(kfa, args, kw, name)
        ms = time_ms(lambda: kfa.flash_attention(*args, **kw), flush)
        log(f"K5 {name}: B={B} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} d={d} "
            f"kv_len={kv_len}: max abs err on live rows {err:.4g} (atol "
            f"2e-2), two launches bit-equal, kernel {ms:.4f} ms")


def flash_sweep(dev, g, flush):
    """Log only: K5 against scaled_dot_product_attention(is_causal=True,
    enable_gqa=True) on the same causal mask at bench_attention's shape (B
    4, Hq 16, Hkv 4, d 128), S = 512 to 8192, in TFLOP/s of causal work."""
    import torch

    import torch.nn.functional as F

    from physics_llm_inference_tpu_torch.kernels import flash_attention as kfa

    B, hq, hkv, d = 4, 16, 4, 128
    for s in (512, 1024, 2048, 4096, 8192):
        q = torch.randn((B, hq, s, d), generator=g, device=dev).bfloat16()
        k = torch.randn((B, hkv, s, d), generator=g, device=dev).bfloat16()
        v = torch.randn((B, hkv, s, d), generator=g, device=dev).bfloat16()
        ms = time_ms(lambda: kfa.flash_attention(q, k, v), flush)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), flush)
        flop = 4 * B * hq * s * s * d * 0.5
        log(f"K5 sweep S={s}: kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} "
            f"TFLOP/s), scaled_dot_product_attention(is_causal, enable_gqa) "
            f"{lib:.4f} ms ({flop / lib / 1e9:.1f} TFLOP/s)")


def _scattered_tables(g, dev, B, MB, NB, used, trash):
    """Block tables drawn from a permutation of the pool's blocks: request
    b's first used[b] columns; the other columns on the trash block."""
    import torch

    perm = torch.randperm(NB - 1, generator=g, device=dev)[:B * MB]
    tables = perm.reshape(B, MB).to(torch.int32)
    cols = torch.arange(MB, device=dev)[None, :]
    return torch.where(cols < used[:, None], tables,
                       torch.full_like(tables, trash))


def check_paged_attention(dev, flush) -> dict:
    """K6 (INT8 merged pools) and K7 (bf16 pools) at B = 64, Hq 32, Hkv 8,
    d 128 over 2-layer pools, in the per-op route's geometry (BS 16, MB 64)
    and the default one (BS 512, MB 2): scattered tables, ragged lengths
    with 1, block boundaries and the whole table; then K7 at d 120. Returns
    their entries, from the per-op geometry that the engine's per-op routes
    run."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import paged_attention as kp

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    B, hq, hkv, d, L = 64, 32, 8, 128, 2
    out = {}
    for bs, mb in ((16, 64), (512, 2)):
        cap, NB = bs * mb, B * mb + 17
        lens = torch.randint(1, cap + 1, (B,), generator=g, device=dev)
        lens[:6] = torch.tensor([1, bs, bs + 1, cap - 1, cap, 2 * bs],
                                device=dev)
        tables = _scattered_tables(g, dev, B, mb, NB, -(-lens // bs), NB - 1)
        ctx = lens.int()
        q = torch.randn((B, hq, d), generator=g, device=dev).bfloat16()
        kv = torch.randint(-127, 128, (L, NB, 2, bs, hkv * d),
                           dtype=torch.int8, generator=g, device=dev)
        kvs = torch.rand((L, NB, 2, hkv, bs), generator=g, device=dev) * 0.03
        kpool = torch.randn((L, NB, bs, hkv, d), generator=g,
                            device=dev).bfloat16()
        vpool = torch.randn((L, NB, bs, hkv, d), generator=g,
                            device=dev).bfloat16()
        cases = (("int8_paged_decode_attention", "K6", kv, kvs, 1),
                 ("paged_decode_attention", "K7", kpool, vpool, 2))
        for name, tag, a, b, elt in cases:
            fn, plain = getattr(kp, name), getattr(kp, f"{name}_plain")
            args = (q, a, b, tables, ctx)
            got = fn(*args, layer=1).float()
            want = plain(*args, layer=1).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            # other f32 summation orders, a tile-wise online softmax (K6:
            # p * v_scale rounded to bf16 against its running max), bf16 out
            if not bool(torch.isfinite(got).all()) or err > 2e-2:
                raise AssertionError(f"{tag} BS={bs}: max abs err {err:.4g} "
                                     "> 2e-2")
            if not torch.equal(fn(*args, layer=1).float(), got):
                raise AssertionError(f"{tag} BS={bs}: two launches differ")
            ms = time_ms(lambda f=fn, x=args: f(*x, layer=1), flush)
            pms = time_ms(lambda f=plain, x=args: f(*x, layer=1), flush)
            live = int(lens.sum()) * hkv * d * 2 * elt
            log(f"{tag} {name} B={B} Hq={hq} Hkv={hkv} d={d} BS={bs} MB={mb} "
                f"(scattered tables, ragged lengths): max_abs_err {err:.4g} "
                f"(atol 2e-2), two launches bit-equal, kernel {ms:.4f} ms "
                f"({live / ms / 1e6:.0f} GB/s of live KV), plain {pms:.4f} ms")
            if bs == 16:
                keys = int(lens.sum())
                out[name] = entry(
                    err, ms, pms, keys * hkv * (2 * d * elt + (8 if elt == 1
                                                               else 0))
                    + 2 * nbytes(q) + nbytes(tables, ctx), 4 * hq * d * keys)
    # K7 at head_dim 120 (a multiple of 8, not of 16: the loop zero-fills
    # its last k16 chunk) in the per-op geometry, over the same tables
    d = 120
    bs, mb = 16, 64
    NB = B * mb + 17
    lens = torch.randint(1, bs * mb + 1, (B,), generator=g, device=dev)
    tables = _scattered_tables(g, dev, B, mb, NB, -(-lens // bs), NB - 1)
    q = torch.randn((B, hq, d), generator=g, device=dev).bfloat16()
    kpool, vpool = (torch.randn((L, NB, bs, hkv, d), generator=g,
                                device=dev).bfloat16() for _ in "kv")
    args = (q, kpool, vpool, tables, lens.int())
    got = kp.paged_decode_attention(*args, layer=1).float()
    want = kp.paged_decode_attention_plain(*args, layer=1).float()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > 2e-2:
        raise AssertionError(f"K7 d={d}: max abs err {err:.4g} > 2e-2")
    if not torch.equal(kp.paged_decode_attention(*args, layer=1).float(), got):
        raise AssertionError(f"K7 d={d}: two launches differ")
    ms = time_ms(lambda: kp.paged_decode_attention(*args, layer=1), flush)
    live = int(lens.sum()) * hkv * d * 2 * 2
    log(f"K7 paged_decode_attention B={B} Hq={hq} Hkv={hkv} d={d} BS={bs} "
        f"MB={mb}: max_abs_err {err:.4g} (atol 2e-2), two launches bit-equal, "
        f"kernel {ms:.4f} ms ({live / ms / 1e6:.0f} GB/s of live KV)")
    return out


def check_fused_paged(dev, flush):
    """K8 at the 7B widths, 2 layers, in the engine's default geometry:
    B = 64, BS = 512, MB = 2, NB = 161 (160 blocks + the trash block), in
    place. Scattered tables covering each active row's write position,
    ragged lengths with block-boundary rows, and 8 inactive rows on the
    trash block with stale lengths (up to past the table). Returns its
    entry (max_abs_err of x_out on the active rows)."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import fused_decode as kf
    from physics_llm_inference_tpu_torch.kernels.paged_attention import \
        write_position
    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import init_params_int8
    from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies

    cfg = ModelConfig(num_layers=2, **WIDTHS)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    blocks = init_params_int8(g, cfg)["blocks"]
    L, B, BS, MB, NB = 2, 64, 512, 2, 161
    trash, cap = NB - 1, MB * BS
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    lens = torch.randint(1, cap, (B,), generator=g, device=dev)
    lens[:6] = torch.tensor([BS - 1, BS, BS + 1, 1, cap - 1, 2 * BS - 2],
                            device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[-8:] = False
    lens[-8:] = torch.tensor([0, 5, BS, cap - 1, cap, cap + 3, 700, 1],
                             device=dev)
    used = torch.where(active, lens // BS + 1, torch.zeros_like(lens))
    tables = _scattered_tables(g, dev, B, MB, NB, used, trash)
    kv = torch.randint(-127, 128, (L, NB, 2, BS, hkv * hd), dtype=torch.int8,
                       generator=g, device=dev)
    kvs = torch.rand((L, NB, 2, hkv, BS), generator=g, device=dev) * 0.03
    x = (torch.randn((B, cfg.hidden_dim), generator=g, device=dev)
         * cfg.hidden_dim ** -0.5).bfloat16()
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    pos = lens.clamp(max=cfg.max_seq_len - 1)
    args = (tables, lens.int(), cos[pos], sin[pos], cfg)
    got_p, want_p = [kv.clone(), kvs.clone()], [kv.clone(), kvs.clone()]
    got = kf.fused_paged_decode_step(blocks, x, *got_p, *args, inplace=True)
    want = kf.fused_paged_decode_step_plain(blocks, x, *want_p, *args,
                                            inplace=True)
    torch.cuda.synchronize()
    xa, xw = got[0].float()[active], want[0].float()[active]
    rel = row_rel(xa, xw)
    if not bool(torch.isfinite(got[0]).all()) or rel > 2e-2:
        raise AssertionError(f"K8: x_out row-wise relative error {rel:.4g} "
                             "> 2e-2 on the active rows")
    codes = []
    for i, name in ((1, "k"), (3, "v")):
        d = (got[i].int() - want[i].int()).abs()
        # layer 0 sees the same x on every row; the kernel's f32 sums and
        # cuBLAS's run in other orders, so a bf16 rounding of qkv can flip
        l0 = float((d[0] == 0).float().mean())
        deep = float((d[1:][:, active] <= 1).float().mean())
        if int(d[0].max()) > 1 or l0 < 0.999 or deep < 0.99:
            raise AssertionError(f"K8: {name} codes: layer 0 max diff "
                                 f"{int(d[0].max())}, equal {l0:.5f}; deeper "
                                 f"within one level {deep:.5f}")
        codes.append(f"{name} layer-0 codes equal {l0:.5f}, deeper within "
                     f"one level {deep:.5f}")
    # the pools: unchanged outside the written slots and the trash block;
    # each active row's slot holds the codes the launch returned
    blk, off = write_position(tables, lens, BS)
    keep = torch.ones((NB, BS), dtype=torch.bool, device=dev)
    keep[blk, off] = False
    keep[trash] = False
    for p in (got_p, want_p):
        if not (torch.equal(p[0].transpose(2, 3)[:, keep],
                            kv.transpose(2, 3)[:, keep])
                and torch.equal(p[1].permute(0, 1, 4, 2, 3)[:, keep],
                                kvs.permute(0, 1, 4, 2, 3)[:, keep])):
            raise AssertionError("K8: the pools changed outside the written "
                                 "slots and the trash block")
    ba, oa = blk[active], off[active]
    if not (torch.equal(got_p[0][:, ba, 0, oa], got[1][:, active])
            and torch.equal(got_p[0][:, ba, 1, oa], got[3][:, active])
            and torch.equal(got_p[1][:, ba, 0, :, oa],
                            got[2][:, active].transpose(0, 1))
            and torch.equal(got_p[1][:, ba, 1, :, oa],
                            got[4][:, active].transpose(0, 1))):
        raise AssertionError("K8: a written slot differs from the returned "
                             "codes")
    # fixed-order sums, no float atomics: a second launch on the same
    # inputs gives the same bits on the active rows and outside the trash
    again_p = [kv.clone(), kvs.clone()]
    again = kf.fused_paged_decode_step(blocks, x, *again_p, *args,
                                       inplace=True)
    if not torch.equal(again[0][active], got[0][active]) or not all(
            torch.equal(a[:, :trash], b[:, :trash])
            for a, b in zip(again_p, got_p)):
        raise AssertionError("K8: two launches on the same inputs differ")
    err = float((xa - xw).abs().max())
    ms = time_ms(lambda: kf.fused_paged_decode_step(blocks, x, *got_p, *args,
                                                    inplace=True), flush)
    pms = time_ms(lambda: kf.fused_paged_decode_step_plain(
        blocks, x, *want_p, *args, inplace=True), flush)
    wbytes = sum(blocks[n].q.numel() for n in ("wqkv", "wo", "w_gate_up",
                                               "w_down"))
    live = int(lens[active].sum()) * L * hkv * hd * 2
    log(f"K8 fused_paged_decode_step 7B widths L={L} B={B} BS={BS} MB={MB} "
        f"NB={NB}, in place, 8 inactive rows on the trash block: x_out "
        f"row-wise rel err {rel:.4g} (2e-2) on the active rows, max abs "
        f"{err:.4g}; {'; '.join(codes)}; pools unchanged outside the written "
        f"slots and the trash block; two launches bit-equal; kernel "
        f"{ms:.4f} ms ({(wbytes + live) / ms / 1e6:.0f} GB/s of weights + "
        f"live KV), plain {pms:.4f} ms; output digest "
        f"{digest(got[0][active], *(t[:, active] for t in got[1:5]))}")
    b, f = fused_bound(blocks, x, L, hkv, hd, cfg.num_heads,
                       int(lens[active].sum()), int(active.sum()))
    return entry(err, ms, pms, b + nbytes(tables, lens.int()), f)


def check_teaching(dev, flush) -> dict:
    """K9 at 4096^3 bf16 (and 2048^3 f32), K10 and K11 at the membench
    default of 256 MiB (K11 also at 2 GiB) and K12 at (524288, 128) f32 (and
    bf16), each against its plain version and timed beside its library
    call. Returns the entries of the microbenchmark path's shapes."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import hello_pallas as kv
    from physics_llm_inference_tpu_torch.kernels import matmul as kt
    from physics_llm_inference_tpu_torch.kernels import membench as kb

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = {}
    # K9: another f32 summation order, then one cast: bf16 rtol 1e-2 plus
    # 1e-3 of the output's max (as K1); f32 in full f32 on both sides
    # (allow_tf32 off) rtol 1e-4 plus 1e-4 of the max. Each shape must go
    # through its route's counter: 4096^3 and the ragged (100, 72, 200)
    # bf16 through wgmma (TMA zero-fills past M, N and K), N % 8 != 0
    # through WMMA
    counters = {"wgmma": "launches", "wmma": "wmma_launches",
                "f32": "f32_launches"}
    for (m, k, n), dtype, rtol, atol, body in (
            ((4096,) * 3, torch.bfloat16, 1e-2, 1e-3, "wgmma"),
            ((2048,) * 3, torch.float32, 1e-4, 1e-4, "f32"),
            ((100, 72, 200), torch.bfloat16, 1e-2, 1e-3, "wgmma"),
            ((256, 256, 100), torch.bfloat16, 1e-2, 1e-3, "wmma")):
        a = torch.randn((m, k), generator=g, device=dev).to(dtype)
        b = torch.randn((k, n), generator=g, device=dev).to(dtype)
        before = {c: getattr(kt, c) for c in counters.values()}
        got = kt.tiled_matmul(a, b).float()
        moved = {c: getattr(kt, c) - before[c] for c in counters.values()}
        if moved != {c: int(c == counters[body]) for c in counters.values()}:
            raise AssertionError(f"K9 ({m},{k},{n}) {dtype}: route counters "
                                 f"moved {moved}, expected {body}")
        want = kt.tiled_matmul_plain(a, b).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        bound = rtol * want.abs() + atol * float(want.abs().max())
        if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
            raise AssertionError(f"K9 ({m},{k},{n}) {dtype}: max err "
                                 f"{float(err.max()):.4g} exceeds rtol {rtol}")
        what = (f"K9 tiled_matmul ({m},{k},{n}) {str(dtype)[6:]} via {body}: "
                f"max_abs_err {float(err.max()):.4g} (rtol {rtol} + {atol} "
                f"of the max)")
        if m < 1024:
            log(what)
            continue
        ms = time_ms(lambda: kt.tiled_matmul(a, b), flush)
        pms = time_ms(lambda: kt.tiled_matmul_plain(a, b), flush)
        lib = time_ms(lambda: torch.matmul(a, b), flush)
        flop = 2 * m * n * k
        log(f"{what}, kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s), "
            f"plain {pms:.4f} ms, torch.matmul {lib:.4f} ms "
            f"({flop / lib / 1e9:.1f} TFLOP/s)")
        if "tiled_matmul" not in out:
            out["tiled_matmul"] = entry(
                float(err.max()), ms, pms, 3 * nbytes(a), flop,
                "bf16" if dtype == torch.bfloat16 else "fp32", lib)
        del a, b, got, want, err, bound

    # K10/K11 at 256 MiB (K11 also at 2 GiB), f32 (N, 128): bit-equal to
    # the plain version and the library call, each timed; then ragged and
    # unaligned shapes
    for mib in (256, 2048):
        x = torch.randn((mib * (1 << 20) // 512, 128), generator=g,
                        device=dev)
        cases = [("strided_copy", "K11", kb._strided_copy,
                  kb._strided_copy_plain,
                  lambda: x.view(-1, 32, 8, 128)[:, 0].contiguous().view(-1, 128))]
        if mib == 256:
            cases.insert(0, ("stream_copy", "K10", kb._stream_copy,
                             kb._stream_copy_plain, x.clone))
        for name, tag, fn, plain, library in cases:
            got = fn(x)
            want = plain(x)
            if not torch.equal(got, want) or not torch.equal(got, library()):
                raise AssertionError(f"{tag} at {mib} MiB: not bit-equal")
            ms = time_ms(lambda: fn(x), flush)
            pms = time_ms(lambda: plain(x), flush)
            lib = time_ms(library, flush)
            moved = 2 * nbytes(got)
            log(f"{tag} {name} {mib} MiB: bit-equal to plain and library, "
                f"kernel {ms:.4f} ms ({moved / ms / 1e6:.0f} GB/s read + "
                f"write), plain {pms:.4f} ms, library {lib:.4f} ms "
                f"({moved / lib / 1e6:.0f} GB/s)")
            if mib == 256:
                out[name] = entry(0.0, ms, pms, moved, 0, library_ms=lib)
            del got, want
        del x
        torch.cuda.empty_cache()
    # ragged row blocks (a 16-byte multiple and not), odd offsets
    base = torch.randint(0, 256, (3 * 40960 + 48,), dtype=torch.uint8,
                         generator=g, device=dev)
    for off, lanes, rows, stride in ((0, 4096, 3, 1), (0, 20480, 1, 2),
                                     (16, 4096, 2, 3), (1, 4096, 1, 1),
                                     (0, 4088, 2, 2)):
        xr = base[off:off + lanes * ((base.numel() - off) // lanes)].view(
            -1, lanes)
        blocks = xr.shape[0] // (rows * stride)
        if not torch.equal(kb._row_block_copy(xr, rows, stride, blocks),
                           kb._row_blocks_plain(xr, rows, stride, blocks)):
            raise AssertionError(f"K10/K11 at offset {off}, {lanes} lanes, "
                                 f"{rows} rows, stride {stride}: not "
                                 "byte-equal")
    log("K10/K11 byte-equal at ragged and unaligned row blocks")

    # K12 at (524288, 128) f32 and bf16: bit-equal to a + b and torch.add,
    # each timed; then ragged and unaligned sizes
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn((524288, 128), generator=g, device=dev).to(dtype)
        b = torch.randn((524288, 128), generator=g, device=dev).to(dtype)
        got = kv.vector_add(a, b)
        if not (torch.equal(got, kv.vector_add_plain(a, b))
                and torch.equal(got, torch.add(a, b))):
            raise AssertionError(f"K12 {dtype}: not bit-equal to a + b")
        ms = time_ms(lambda: kv.vector_add(a, b), flush)
        pms = time_ms(lambda: kv.vector_add_plain(a, b), flush)
        lib = time_ms(lambda: torch.add(a, b), flush)
        moved = 3 * nbytes(a)
        log(f"K12 vector_add (524288, 128) {str(dtype)[6:]}: bit-equal to "
            f"a + b and torch.add, kernel {ms:.4f} ms "
            f"({moved / ms / 1e6:.0f} GB/s), plain {pms:.4f} ms, "
            f"torch.add {lib:.4f} ms")
        if "vector_add" not in out:
            out["vector_add"] = entry(0.0, ms, pms, moved, a.numel(), "fp32",
                                      lib)
        del a, b, got
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.randn(3 * 999_983 + 8, generator=g,
                           device=dev).to(dtype)
        for off, rows, cols in ((0, 999_983, 3), (1, 1, 999_983 * 3),
                                (0, 4096, 257), (8, 2048, 8)):
            a = flat[off:off + rows * cols].view(rows, cols)
            b = flat[-rows * cols:].view(rows, cols)
            if not torch.equal(kv.vector_add(a, b, block_rows=rows),
                               torch.add(a, b)):
                raise AssertionError(f"K12 {dtype} at offset {off}, "
                                     f"({rows}, {cols}): not bit-equal to "
                                     "torch.add")
    log("K12 bit-equal to torch.add at ragged and unaligned sizes")
    return out


def run_slice(params, cfg, prompts, steps_tokens, dev):
    """Prefill + teacher-forced decode steps; returns the prefill logits and,
    per step, the final hidden state handed to the greedy head and the
    tokens it returned."""
    import torch

    from physics_llm_inference_tpu_torch.models import transformer as tf
    from physics_llm_inference_tpu_torch.runtime import generate as gen
    from physics_llm_inference_tpu_torch.runtime.kv_cache import KVCache

    seen = []
    head = tf.lmhead_greedy

    def spy(x, *a, **kw):
        tok = head(x, *a, **kw)
        seen.append((x.float().clone(), tok.clone()))
        return tok

    tf.lmhead_greedy = spy
    try:
        ids, lens = gen.pad_and_stack(prompts, device=dev)
        b, p = ids.shape
        cache = KVCache.create(cfg, b, p + len(steps_tokens),
                               dtype=torch.int8, device=dev)
        logits0, kv, vfrom = gen._prefill(params, cfg, ids, lens,
                                          cache.as_slice())
        for i, tok in enumerate(steps_tokens):
            slot = p + i
            _, kv = tf.forward(
                params, tok[:, None], cfg, kv=tf.KVSlice(kv.k, kv.v, slot),
                positions=(lens + i)[:, None],
                slots=torch.full((b, 1), slot, dtype=torch.int32, device=dev),
                valid_from=vfrom, last_only=True, greedy_head=True)
        torch.cuda.synchronize()
    finally:
        tf.lmhead_greedy = head
    return logits0, seen


class plain_entry_points:
    """Within the block, the transformer's references to every kernel entry
    point are its plain version (here, not in the package)."""

    def __enter__(self):
        from physics_llm_inference_tpu_torch.models import transformer as tf

        self.tf = tf
        self.saved = {n: getattr(tf, n) for n in KERNELS if hasattr(tf, n)}
        for n in self.saved:
            setattr(tf, n, getattr(kernel_module(n), f"{n}_plain"))

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.tf, n, fn)


def lockstep_slice(params, cfg, prompts, steps_tokens, dev):
    """W8A8's phase 4: prefill with the kernels, then each teacher-forced
    decode step from the same cache with the kernels, and with the plain
    entry points on a copy of the cache as it was before the step: as they
    are, and without each quantization point (the controls). Returns per
    step ((hidden, token) of the kernels, (hidden, token) of the plain
    versions, {point: hidden of its control})."""
    import torch

    from physics_llm_inference_tpu_torch.models import transformer as tf
    from physics_llm_inference_tpu_torch.runtime import generate as gen
    from physics_llm_inference_tpu_torch.runtime.kv_cache import KVCache

    ids, lens = gen.pad_and_stack(prompts, device=dev)
    b, p = ids.shape
    cache = KVCache.create(cfg, b, p + len(steps_tokens), dtype=torch.int8,
                           device=dev)
    _, kv, vfrom = gen._prefill(params, cfg, ids, lens, cache.as_slice())

    def step(i, tok, k, v):
        seen = []
        head = tf.lmhead_greedy

        def spy(x, *a, **kw):
            t = head(x, *a, **kw)
            seen.append((x.float().clone(), t.clone()))
            return t

        tf.lmhead_greedy = spy
        try:
            slot = p + i
            tf.forward(params, tok[:, None], cfg, kv=tf.KVSlice(k, v, slot),
                       positions=(lens + i)[:, None],
                       slots=torch.full((b, 1), slot, dtype=torch.int32,
                                        device=dev),
                       valid_from=vfrom, last_only=True, greedy_head=True)
            torch.cuda.synchronize()
        finally:
            tf.lmhead_greedy = head
        return seen[0]

    out = []
    for i, tok in enumerate(steps_tokens):
        was = [t.clone() for t in (kv.k.q, kv.k.s, kv.v.q, kv.v.s)]

        def plain():
            with plain_entry_points():
                return step(i, tok, tf.QuantKV(was[0].clone(), was[1].clone()),
                            tf.QuantKV(was[2].clone(), was[3].clone()))

        got = step(i, tok, kv.k, kv.v)
        want = plain()
        controls = {}
        for point in QUANT_POINTS:
            with quant_point_off(point, cfg.num_layers):
                controls[point] = plain()[0]
        out.append((got, want, controls))
    return out


def slice_parity(dev, fused: bool, mode: str = "w8a16"):
    """Phase 4: kernels vs plain entry points on a 2-layer 7B-width model,
    on the fused decode path in `mode` (FUSED_MODES) or the per-op one."""
    import torch

    from physics_llm_inference_tpu_torch.models import quant
    from physics_llm_inference_tpu_torch.models.config import ModelConfig

    init, act, fused_name, _ = FUSED_MODES[mode]
    cfg = ModelConfig(num_layers=2, fused_decode=fused, act_quant=act,
                      **WIDTHS)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    params = getattr(quant, init)(g, cfg)
    lens = torch.randint(64, PROMPT + 1, (BATCH,), generator=g, device=dev)
    prompts = [torch.randint(1, cfg.vocab_size, (int(n),), generator=g,
                             device=dev).tolist() for n in lens]
    steps = [torch.randint(1, cfg.vocab_size, (BATCH,), generator=g,
                           device=dev) for _ in range(8)]

    path = (("int8_matmul", fused_name, "lmhead_greedy") if fused
            else ("int8_matmul", "int8_kv_decode_attention", "lmhead_greedy"))
    if mode == "w8a8":
        return lockstep_parity(dev, params, cfg, prompts, steps, path)
    before = read_launches()
    logits_k, seen_k = run_slice(params, cfg, prompts, steps, dev)
    after = read_launches()
    used = {n: after[n] - before[n] for n in path}
    if min(used.values()) == 0:
        raise AssertionError(f"slice parity: kernels not all used {used}")
    with plain_entry_points():
        logits_p, seen_p = run_slice(params, cfg, prompts, steps, dev)

    def rel_check(a, b, what):
        # row-wise relative error ||a - b|| / ||b|| (rtol 2e-2): single
        # elements legitimately differ by a bf16 ulp of the residual stream
        # where an int8 KV level or a bf16 rounding flips between the runs
        rel = row_rel(a, b)
        if not bool(torch.isfinite(a).all()) or rel > 2e-2:
            raise AssertionError(f"slice parity {what}: row-wise relative "
                                 f"error {rel:.4g} > 2e-2")
        return rel

    worst = rel_check(logits_k, logits_p, "prefill logits")
    ties, near, eased, close_at = 0, 0, [], 2e-3
    for i, ((xk, tk), (xp, tp)) in enumerate(zip(seen_k, seen_p)):
        worst = max(worst, rel_check(xk, xp, f"step {i} hidden"))
        # the kernel's token must lie within one bf16 ulp of the max of the
        # plain head on the hidden state the kernel run handed it (the head
        # alone), and of the plain run's logits (the path); on a row whose
        # hidden states the two runs round more than 2e-3 apart (W8A8's
        # lockstep threshold), within two ulps of the plain run's max: the
        # plain run's top two logits are then a near-tie within two ulps
        own = ulps_below_max(params, cfg, xk, tk)
        gap = ulps_below_max(params, cfg, xp, tk)
        rel = rows_rel(xk, xp)
        allowed = torch.where(rel > close_at, 2.0, 1.0)
        over = [(r, float(gap[r]), float(rel[r]))
                for r in torch.nonzero(gap > 1).flatten().tolist()]
        if bool((own > 1).any()) or bool((gap > allowed).any()):
            raise AssertionError(
                f"slice parity step {i}: token off the max (kernel run's "
                f"hidden state: {ulp_rows(own, 1)}; plain run's logits, "
                f"(row, ulps, hidden states apart): {over})")
        eased += [f"step {i} row {r} {u:.2f} ulps at hidden {d:.4g}"
                  for r, u, d in over]
        near += int((rel <= close_at).sum())
        ties += int((tk != tp).sum())
    log(f"slice parity, {f'fused {mode.upper()}' if fused else 'per-op'} "
        f"decode (7B widths, 2 layers, B={BATCH}, 8 decode steps): max row-wise "
        f"relative error {worst:.4g} (rtol 2e-2); tokens within one bf16 ulp "
        f"of the max of the plain head on the kernel run's hidden states, and "
        f"of the plain run's logits on every row but {len(eased)} near-ties "
        f"within two ({'; '.join(eased) or 'none'}); {near} of "
        f"{len(seen_k) * BATCH} rows' hidden states within {close_at:g}; "
        f"tokens equal except {ties} bf16 near-ties, kernel launches {used}")


def ulps_below_max(params, cfg, x, tk):
    """Per row, how many bf16 ulps the logit of token `tk` lies below the
    row max of the plain lm_head's logits of the hidden states `x`."""
    import torch

    from physics_llm_inference_tpu_torch.models import transformer as tf

    km = kernel_module("int8_matmul")
    xn = tf.rms_norm(x.bfloat16(), params["norm"], cfg.norm_eps)
    lg = km.int8_matmul_plain(xn, params["lm_head"].q, params["lm_head"].s,
                              out_dtype=torch.float32).bfloat16().float()
    top = lg.max(dim=-1).values
    return (top - lg.gather(1, tk.long()[:, None])[:, 0]) / bf16_ulp(top)


def ulp_rows(ulps, limit: float) -> str:
    """The rows of `ulps` above `limit`, with their ulps."""
    import torch

    rows = torch.nonzero(ulps > limit).flatten().tolist()
    return (f"rows {rows} at {[round(float(ulps[r]), 2) for r in rows]}"
            if rows else f"every row within {limit:g}")


def lockstep_parity(dev, params, cfg, prompts, steps, path):
    """Phase 4 for W8A8 (`lockstep_slice`): each step's hidden state under
    `w8a8_rows_ok`, with its controls. On the rows within 2e-3, at
    least a quarter of all, the kernel's token must be a bf16 max of the
    plain run's logits, as in the other modes; a row moved by a flipped
    activation code may pick another token where the top logits are
    close."""
    before = read_launches()
    pairs = lockstep_slice(params, cfg, prompts, steps, dev)
    after = read_launches()
    used = {n: after[n] - before[n] for n in path}
    if min(used.values()) == 0 or used[path[1]] != len(steps):
        raise AssertionError(f"slice parity W8A8: kernels not used as "
                             f"expected {used}")
    notes, near, differ, close_at = [], 0, 0, 2e-3
    for i, ((xk, tk), (xp, tp), controls) in enumerate(pairs):
        rel = rows_rel(xk, xp)
        notes.append(w8a8_rows_ok(
            rel, {p: rows_rel(c, xp) for p, c in controls.items()},
            f"slice parity W8A8 step {i} hidden"))
        close = rel <= close_at
        if bool((ulps_below_max(params, cfg, xp, tk)[close] > 1).any()):
            raise AssertionError(f"slice parity W8A8 step {i}: token off the "
                                 f"max on a row within {close_at:g}")
        near += int(close.sum())
        differ += int((tk != tp).sum())
    if near < len(pairs) * BATCH // 4:
        raise AssertionError(f"slice parity W8A8: {near} of "
                             f"{len(pairs) * BATCH} rows within "
                             f"{close_at:g}, fewer than a quarter")
    log(f"slice parity, fused W8A8 decode in lockstep (7B widths, 2 layers, "
        f"B={BATCH}, 8 decode steps, each from the kernel run's cache): "
        f"{' | '.join(notes)}; tokens a bf16 max of the plain logits on the "
        f"{near} rows within {close_at:g}; tokens equal except {differ} of "
        f"{len(pairs) * BATCH}; kernel launches {used}")


PAGED_SWAPS = {  # module of the paged path -> the kernel entry points it calls
    "models.paged_transformer": ("flash_attention", "fused_paged_decode_step",
                                 "int8_paged_decode_attention",
                                 "paged_decode_attention"),
    "models.transformer": ("int8_matmul",),
}


def run_paged_slice(params, cfg, prompts, steps, tables, dev):
    """Chunked prefill of the prompts (chunks of 512, as the engine cuts
    them) into fresh INT8 pools in the engine's default geometry (BS 512,
    160 blocks and the trash block), then teacher-forced decode steps at its
    width, with the rows past the prompts inactive on the trash block.
    Returns the prefill logits (n, V) and each step's logits of the prompts'
    rows."""
    import torch

    from physics_llm_inference_tpu_torch.models import paged_transformer as pt
    from physics_llm_inference_tpu_torch.models.transformer import QuantKV

    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    B = tables.shape[0]
    BS, NB = 512, 161
    pools = QuantKV(torch.zeros((L, NB, 2, BS, hkv * hd), dtype=torch.int8,
                                device=dev),
                    torch.zeros((L, NB, 2, hkv, BS), device=dev))
    n = len(prompts)
    plen = torch.tensor([len(p) for p in prompts], device=dev)
    first = torch.zeros((n, cfg.vocab_size), device=dev)
    for start in range(0, int(plen.max()), BS):
        rows = [i for i, p in enumerate(prompts) if len(p) > start]
        ids = torch.zeros((len(rows), BS), dtype=torch.int64, device=dev)
        nval = torch.zeros(len(rows), dtype=torch.int32, device=dev)
        for j, i in enumerate(rows):
            chunk = prompts[i][start:start + BS]
            ids[j, :len(chunk)] = torch.tensor(chunk, device=dev)
            nval[j] = len(chunk)
        idx = torch.tensor(rows, device=dev)
        logits, pools, _ = pt.paged_prefill_chunk_impl(
            params, ids, pools, None, tables[idx],
            torch.full((len(rows),), start, dtype=torch.int32, device=dev),
            nval, cfg)
        done = plen[idx] <= start + BS
        first[idx[done]] = logits[done]
    lens = torch.zeros(B, dtype=torch.int32, device=dev)
    lens[:n] = plen.int()
    seen = []
    for tok in steps:
        logits, pools, _ = pt.paged_decode_step(params, tok, pools, None,
                                                tables, lens, cfg)
        seen.append(logits[:n].clone())
        lens[:n] += 1
    torch.cuda.synchronize()
    return first, seen


def paged_slice_parity(dev):
    """Phase 4, paged: kernels vs plain entry points on a 2-layer 7B-width
    model, 16 requests, in the paged engine's default geometry."""
    import importlib

    import torch

    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import init_params_int8

    cfg = ModelConfig(num_layers=2, **dict(WIDTHS, max_seq_len=1024))
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    params = init_params_int8(g, cfg)
    n, B, MB = 16, 64, 2
    lens = torch.randint(64, 1024 - 16, (n,), generator=g, device=dev)
    lens[:3] = torch.tensor([512, 513, 1000], device=dev)
    prompts = [torch.randint(1, cfg.vocab_size, (int(k),), generator=g,
                             device=dev).tolist() for k in lens]
    perm = torch.randperm(160, generator=g, device=dev)[:n * MB]
    tables = torch.full((B, MB), 160, dtype=torch.int32, device=dev)
    tables[:n] = perm.reshape(n, MB).int()
    steps = []
    for _ in range(8):
        tok = torch.zeros(B, dtype=torch.int64, device=dev)
        tok[:n] = torch.randint(1, cfg.vocab_size, (n,), generator=g,
                                device=dev)
        steps.append(tok)

    reset_launches()
    first_k, seen_k = run_paged_slice(params, cfg, prompts, steps, tables, dev)
    used = read_launches()
    path = ("flash_attention", "fused_paged_decode_step", "int8_matmul")
    if any(used[k] == 0 for k in path) or used["fused_paged_decode_step"] != 8:
        raise AssertionError(f"paged slice parity: kernels not used as "
                             f"expected {used}")
    saved = []
    for mod_name, names in PAGED_SWAPS.items():
        mod = importlib.import_module(f"{PKG}.{mod_name}")
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, getattr(kernel_module(name), f"{name}_plain"))
    try:
        first_p, seen_p = run_paged_slice(params, cfg, prompts, steps, tables,
                                          dev)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    worst, ties = 0.0, 0
    pairs = [("prefill", first_k, first_p)] + [
        (f"step {i}", a, b) for i, (a, b) in enumerate(zip(seen_k, seen_p))]
    for what, a, b in pairs:
        # row-wise relative error (rtol 2e-2): single logits differ by bf16
        # ulps where an int8 level or a bf16 rounding flips between the runs
        rel = row_rel(a, b)
        if not bool(torch.isfinite(a).all()) or rel > 2e-2:
            raise AssertionError(f"paged slice parity, {what}: row-wise "
                                 f"relative error {rel:.4g} > 2e-2")
        worst = max(worst, rel)
        tk, tp = a.argmax(dim=-1), b.argmax(dim=-1)
        # where the tokens differ, the kernel's token is a bf16 max of the
        # plain run's logits
        top = b.max(dim=-1).values
        gap = top - b.gather(1, tk[:, None])[:, 0]
        if bool((gap > bf16_ulp(top)).any()):
            raise AssertionError(f"paged slice parity, {what}: token off the "
                                 "max")
        ties += int((tk != tp).sum())
    log(f"slice parity, paged (7B widths, 2 layers, {n} requests of prompt "
        f"{int(lens.min())}-{int(lens.max())} at decode width {B}, BS=512, "
        f"MB=2; chunked flash prefill, 8 teacher-forced fused paged decode "
        f"steps): max row-wise relative error {worst:.4g} (rtol 2e-2), "
        f"tokens equal except {ties} bf16 near-ties, kernel launches "
        f"{ {k: used[k] for k in path} }")


def kernel_ms(fn) -> float:
    """Device ms of the CUDA kernels fn() runs, by torch.profiler (kernel
    rows only: a host op's device time would count its kernels twice)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        total += (getattr(e, "self_cuda_time_total", 0.0) if us is None
                  else us) / 1e3
    return total


def eager_decode(params, cfg, prompts, fused: bool, steps):
    """cached_generate's greedy prefill and decode loop with every step of
    the loop called eagerly, here (no graph): its tokens, its decode
    seconds and, on the per-op path, the host's share of a step (wall less
    the device time of its kernels) for the eager step and for a replay of
    `steps`' captured step."""
    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.ops.sampling import sample_token
    from physics_llm_inference_tpu_torch.runtime import generate as gen

    dev = params["embed"].device
    ids, lens = gen.pad_and_stack(prompts, device=dev)
    b, p = ids.shape
    cap = -(-(p + NEW_TOKENS) // 128) * 128
    loop = gen.DecodeLoop(params, cfg, b, cap, torch.int8, True, 0, False,
                          (), 0, None)
    logits0, _, vfrom = gen._prefill(params, cfg, ids, lens,
                                     loop.cache.as_slice())
    first = sample_token(logits0, None, temperature=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.begin(first, lens, vfrom, p, 0.0, 1.0)
    for _ in range(NEW_TOKENS):
        loop.step()
    toks = loop.emitted[:, :NEW_TOKENS].cpu().numpy().astype(np.int32)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    host = ""
    if not fused:
        (graph_loop, replay), = [v for v in steps._cache.values()]
        reps = 4
        walls, devs = [], []
        for state, one in ((loop, loop.step), (graph_loop, replay)):
            state.i.zero_()   # steps inside the cache's capacity
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                one()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / reps * 1e3)
            devs.append(kernel_ms(lambda: [one() for _ in range(reps)])
                        / reps)
        host = ("host share of a per-op step (wall less its kernels' "
                "device time, torch.profiler): eager "
                f"{walls[0]:.3f} - {devs[0]:.3f} ms = "
                f"{(walls[0] - devs[0]) / walls[0]:.3f} of the wall, replay "
                f"{walls[1]:.3f} - {devs[1]:.3f} ms = "
                f"{(walls[1] - devs[1]) / walls[1]:.3f}")
    del loop
    return toks, eager_s, host


def full_run(dev, params, prompt: int, fused: bool, layers: int,
             expect, mode: str = "w8a16", readings: dict | None = None
             ) -> dict:
    """Phase 5: one path of the main path at full width, `layers` deep, the
    fused decode in `mode` (FUSED_MODES). Returns the launch counts of its
    timed run; `readings`, if given, gets its replay's ms a step."""
    import torch

    from physics_llm_inference_tpu_torch.bench.headline import \
        speed_of_light_tok_s
    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.runtime.generate import (
        cached_generate, decode_step_cache)
    from physics_llm_inference_tpu_torch.specs.gpu import get_gpu_spec

    _, act, fused_name, wbits = FUSED_MODES[mode]
    cfg = ModelConfig(num_layers=layers, fused_decode=fused, act_quant=act,
                      **WIDTHS)
    g = torch.Generator().manual_seed(SEED + prompt)
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, prompt),
                            generator=g).tolist()
    steps = decode_step_cache()

    def run():
        return cached_generate(params, cfg, prompts, NEW_TOKENS,
                               temperature=0.0, kv_dtype=torch.int8,
                               step_cache=steps)

    t0 = time.perf_counter()
    run()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = run()
    counts = read_launches()
    what = (f"{layers}-layer 7B, prompt {prompt}, "
            f"{f'fused {mode.upper()}' if fused else 'per-op'} decode")
    log(f"{what}: warm-up run {warm:.1f} s; launches during the timed run: "
        f"{counts}")
    missing = [n for n in expect if counts[n] == 0]
    others = [FUSED_MODES[m][2] for m in FUSED_MODES if m != mode]
    if missing or (fused and counts[fused_name] != NEW_TOKENS) or any(
            counts[n] for n in others):
        raise AssertionError(f"{what}: kernels of the path not launched "
                             f"as expected: {counts}")
    if steps.stats() != {"compiled_shapes": 1, "hits": 1, "misses": 1}:
        raise AssertionError(f"{what}: the timed run did not replay the "
                             f"warm run's graph: {steps.stats()}")
    eager_toks, eager_s, host = eager_decode(params, cfg, prompts, fused,
                                             steps)
    if not (eager_toks == out.tokens).all():
        raise AssertionError(f"{what}: graph replay's greedy tokens differ "
                             "from the eager loop's at "
                             f"{int((eager_toks != out.tokens).sum())} places")
    n_tok = BATCH * NEW_TOKENS
    if readings is not None:
        readings["ms_a_step"] = out.decode_s / NEW_TOKENS * 1e3
    log(f"{what}: graph replay {out.decode_s / NEW_TOKENS * 1e3:.3f} ms a "
        f"step, {out.decode_tokens_per_s:.1f} tok/s; eager loop "
        f"{eager_s / NEW_TOKENS * 1e3:.3f} ms a step, "
        f"{n_tok / eager_s:.1f} tok/s; greedy tokens identical; {host}")
    toks = out.tokens
    if toks.shape != (BATCH, NEW_TOKENS) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens: shape {toks.shape}, range "
                             f"[{toks.min()}, {toks.max()}]")

    spec = get_gpu_spec()
    # the weights at their width, as bench.py:120 counts them (INT4: half a
    # byte a parameter; scales left out)
    floor_s = BATCH / speed_of_light_tok_s(cfg, BATCH, prompt, NEW_TOKENS,
                                           wbits, spec)
    tok_s = out.decode_tokens_per_s
    share = tok_s * floor_s / BATCH
    log(f"{what} (B={BATCH}, {NEW_TOKENS} greedy tokens, "
        f"{mode.upper()} with INT8 KV): "
        f"prefill (TTFT) {out.prefill_s * 1e3:.1f} ms, decode "
        f"{out.decode_s * 1e3:.1f} ms, {tok_s:.1f} tok/s, "
        f"{out.time_per_output_token_s * 1e3:.2f} ms/step; HBM floor "
        f"{floor_s * 1e6:.0f} us/step on {spec.name} spec "
        f"({spec.hbm_gbps:.0f} GB/s) -> share {share:.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return counts


def decode_alone(dev):
    """--decode: phase 5's cached_generate at prompt 128 in each K4 mode
    and on the per-op path, 32 layers, each a warm-up run, a timed run and
    the eager loop."""
    import torch

    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import (init_params_int4,
                                                              init_params_int8)

    cfg = ModelConfig(num_layers=32, **WIDTHS)
    for mode, (init, _, name, _) in FUSED_MODES.items():
        init_fn = {"init_params_int8": init_params_int8,
                   "init_params_int4": init_params_int4}[init]
        params = init_fn(torch.Generator(device=dev).manual_seed(SEED), cfg)
        full_run(dev, params, PROMPT, True, 32,
                 ("int8_matmul", name, "lmhead_greedy"), mode=mode)
        if mode == "w8a16":
            full_run(dev, params, PROMPT, False, 32,
                     ("int8_matmul", "int8_kv_decode_attention",
                      "lmhead_greedy"))
        del params
        torch.cuda.empty_cache()


def sampled_run(dev, params, cfg):
    """cached_generate sampled (temperature 0.8, top-k 50, top-p 0.9) with
    a new caller's generator from one seed, twice through one step cache:
    which form its decode loop ran in (a CUDA graph with the loop's own
    generator registered, or eager), the second call replaying the first
    one's entry, and the two runs' tokens and the callers' generator states
    after them equal."""
    import torch

    from physics_llm_inference_tpu_torch.runtime.generate import (
        cached_generate, decode_step_cache)
    from physics_llm_inference_tpu_torch.runtime.step_cache import \
        CapturedStep

    g = torch.Generator().manual_seed(SEED + 5)
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, PROMPT),
                            generator=g).tolist()
    steps = decode_step_cache()
    outs, states = [], []
    for _ in range(2):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        outs.append(cached_generate(params, cfg, prompts, 16, generator=gen,
                                    temperature=0.8, top_k=50, top_p=0.9,
                                    kv_dtype=torch.int8, step_cache=steps))
        states.append(gen.get_state())
    captured = all(isinstance(step, CapturedStep)
                   for _, step in steps._cache.values())
    same = bool((outs[0].tokens == outs[1].tokens).all())
    hit = steps.stats() == {"compiled_shapes": 1, "hits": 1, "misses": 1}
    log(f"sampled cached_generate (B={BATCH}, prompt {PROMPT}, 16 tokens, "
        "T 0.8, top-k 50, top-p 0.9): its decode loop ran "
        + ("as a CUDA graph with its generator registered"
           if captured else "eagerly")
        + f"; the second caller's generator replayed the first one's entry: "
        f"{hit}; two runs from one seed give equal tokens: {same}; decode "
        f"{outs[1].decode_s / 16 * 1e3:.3f} ms a step, "
        f"{outs[1].decode_tokens_per_s:.1f} tok/s")
    if not (same and hit and torch.equal(*states)):
        raise AssertionError("sampled cached_generate: two runs from one "
                             f"seed differ (tokens equal {same}, cache hit "
                             f"{hit}, generator states equal "
                             f"{torch.equal(*states)})")


def full_runs(dev):
    """Phase 5: the default config at prompt 128 and 512, then the per-op
    decode path, then W8A8 and W4A16 at prompt 128. Returns each kernel's
    launches summed over the timed runs, the INT8 parameters and the
    default decode's ms a step at prompt 128."""
    import torch

    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import (
        init_params_int4, init_params_int8, quantized_param_bytes)

    cfg = ModelConfig(num_layers=32, **WIDTHS)
    t0 = time.perf_counter()
    params = init_params_int8(torch.Generator(device=dev).manual_seed(SEED),
                              cfg)
    torch.cuda.synchronize()
    log(f"7B init on the card: {cfg.param_count() / 1e9:.2f}B params, "
        f"{time.perf_counter() - t0:.1f} s")
    fused = ("int8_matmul", "fused_decode_step", "lmhead_greedy")
    readings = {}
    runs = [full_run(dev, params, PROMPT, True, 32, fused,
                     readings=readings),
            full_run(dev, params, LONG_PROMPT, True, 32,
                     fused + ("flash_attention",)),
            full_run(dev, params, PROMPT, False, 32,
                     ("int8_matmul", "int8_kv_decode_attention",
                      "lmhead_greedy")),
            # W8A8: the same INT8 weights, activations quantized in K4
            full_run(dev, params, PROMPT, True, 32,
                     ("int8_matmul", "fused_decode_step_w8a8",
                      "lmhead_greedy"), mode="w8a8")]
    sampled_run(dev, params, cfg)
    # W4A16: INT4 block weights (the lm_head int8), prefill linears
    # dequantized into a library GEMM, K1 on the lm_head, K3, K4 W4A16
    t0 = time.perf_counter()
    p4 = init_params_int4(torch.Generator(device=dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    log(f"7B INT4 init on the card: {time.perf_counter() - t0:.1f} s, "
        f"{quantized_param_bytes(p4)}")
    runs.append(full_run(dev, p4, PROMPT, True, 32,
                         ("int8_matmul", "fused_decode_step_w4a16",
                          "lmhead_greedy"), mode="w4a16"))
    del p4
    torch.cuda.empty_cache()
    # bench.py's protocol on the card in its default configuration (W8A16)
    from physics_llm_inference_tpu_torch.bench import headline

    t0 = time.perf_counter()
    res = headline.main()
    torch.cuda.empty_cache()
    log(f"bench/headline.main(): {json.dumps(res)} ({nvidia_smi()}; "
        f"{time.perf_counter() - t0:.1f} s with its 7B init)")
    return ({n: sum(r[n] for r in runs) for n in KERNELS}, params,
            readings["ms_a_step"])


class CallTime:
    """Device time of every call of `module.name` inside the block: a CUDA
    event pair recorded on the stream around each call, read at the end. It
    bounds the call's kernels from above: a pair also holds any time the
    device waits for the host between the two records."""

    def __init__(self, module, name: str):
        self.module, self.name, self.pairs = module, name, []

    def __enter__(self):
        import torch

        self.fn = getattr(self.module, self.name)

        def spy(*a, **kw):
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
            out = self.fn(*a, **kw)
            pair[1].record()
            self.pairs.append(pair)
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


class K1Census:
    """K1's launches inside the block by route and row count M: a spy on
    the name models/transformer._linear calls (every K1 call of the model
    goes through it), keyed on the route whose launch counter the call
    moved."""

    def __init__(self):
        from physics_llm_inference_tpu_torch.models import transformer

        self.module, self.seen = transformer, {}

    def __enter__(self):
        from physics_llm_inference_tpu_torch.kernels import int8_matmul as km

        self.fn = self.module.int8_matmul

        def counts():
            return [getattr(km, f"{r}_launches") for r in km.ROUTES]

        def spy(x, w, s, *a, **kw):
            before = counts()
            out = self.fn(x, w, s, *a, **kw)
            moved = [r for r, b, c in zip(km.ROUTES, before, counts())
                     if c != b]
            key = (moved[0] if len(moved) == 1 else f"launched {moved}",
                   x.shape[0], w.shape[-1])
            self.seen[key] = self.seen.get(key, 0) + 1
            return out

        self.module.int8_matmul = spy
        return self

    def __exit__(self, *exc):
        self.module.int8_matmul = self.fn

    def report(self) -> str:
        by = {}
        for (r, m, n), c in self.seen.items():
            by[r, m] = by.get((r, m), 0) + c
        return ", ".join(f"{r} M={m}: {c}" for (r, m), c in
                         sorted(by.items(), key=lambda kv: kv[0][1]))

    def launched(self, route: str, n: int | None = None) -> bool:
        """Whether `route` took a call (with N = n, if given)."""
        return any(r == route and n in (None, nn)
                   for r, _, nn in self.seen)


def profile_wave(run, what: str, wall_s: float):
    """One wave under torch.profiler: device ms by kernel (the ten largest,
    K1's kernels apart); their sum over `wall_s`, the unprofiled wall of a
    wave like it, is the kernels' share of the wall (the profiler itself
    slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue   # a host op: its kernels are rows of their own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    k1 = [r for r in rows if "int8_matmul" in r[2] or "splitk" in r[2]]
    log(f"{what}, profiled wave: wall {wall:.3f} s (profiler on); kernels "
        f"{total:.1f} ms of device time, {total / 1e3 / wall_s:.4f} of the "
        f"measured wave's {wall_s:.3f} s; K1 {sum(r[0] for r in k1):.1f} ms "
        f"over {sum(r[1] for r in k1)} kernel launches ("
        + "; ".join(f"{name[:60]} {ms:.1f} ms x {c}" for ms, c, name in k1)
        + "); largest: "
        + "; ".join(f"{name[:60]} {ms:.1f} ms x {c}"
                    for ms, c, name in rows[:10]))


def eager_engine_class():
    """PagedInferenceEngine with its two dispatch functions called eagerly,
    here, not through a switch in the package: the prefill chunk and the
    decode horizon as plain calls of the model functions on fresh device
    tensors, with no graph."""
    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.models.paged_transformer import (
        paged_decode_scan_impl, paged_prefill_chunk_impl)
    from physics_llm_inference_tpu_torch.serve.paged_engine import \
        PagedInferenceEngine

    class EagerEngine(PagedInferenceEngine):
        def _t(self, a):
            return torch.tensor(np.asarray(a), device=self.device)

        def _prefill(self, ids, tables, starts, nval):
            logits, self._k, self._v = paged_prefill_chunk_impl(
                self.params, self._t(ids), self._k, self._v, self._t(tables),
                self._t(starts), self._t(nval), self.cfg)
            return logits

        def _decode(self, horizon, filtered, tokens, tables, temps, top_ks,
                    top_ps):
            toks, self._k, self._v = paged_decode_scan_impl(
                self.params, self._t(tokens), self._k, self._v,
                self._t(tables), self._t(self._lengths), self._rng,
                self._t(temps), self._t(top_ps), self.cfg, horizon=horizon,
                top_ks=self._t(top_ks), filtered=filtered)
            return toks.cpu().numpy()

    return EagerEngine


def serve(dev, params, cfg, what: str, kw: dict, n: int, prompt: int,
          tokens: int, expect, forbid, shared: bool = False,
          warm: int = 0, waves: int = 1, compare: bool = False,
          profiled: bool = False) -> dict:
    """Phase 5, paged: one PagedInferenceEngine (its dispatch steps captured
    as CUDA graphs by `warmup()` and at first use) serving `waves` waves of
    n greedy requests, each submitted at once and run to the end, each
    after a warm wave of `warm` requests (16 tokens each, not measured).
    Every measured wave repeats one workload: the radix cache is emptied
    (its blocks back to the pool) before each warm wave, and the warm and
    the measured waves draw the same prompts each time. With
    `shared`, every fourth prompt starts with one of SHARED_PREFIXES
    block-sized prefixes, as in scripts/bench_serving7b.py. With `compare`,
    the same request stream goes through the engine with eager dispatch
    functions (eager_engine_class) too: tokens, finish reasons and each
    wave's dispatch_trace must be identical; K1's launches are counted by
    route and M over the eager waves (a replay calls no Python). With
    `profiled`, one more wave of the captured engine runs under
    torch.profiler. Returns the launch counts summed over the captured
    engine's measured waves."""
    import contextlib
    import gc

    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.models import \
        paged_transformer as paged_model
    from physics_llm_inference_tpu_torch.serve.engine import GenerationRequest
    from physics_llm_inference_tpu_torch.serve.paged_engine import (
        PagedEngineConfig, PagedInferenceEngine)

    pc = PagedEngineConfig(**kw)
    engines = [("captured", PagedInferenceEngine)]
    if compare:
        engines.append(("eager", eager_engine_class()))
    seen, total = {}, {k: 0 for k in KERNELS}
    for label, cls in engines:
        eng = cls(params, cfg, pc)
        t0 = time.perf_counter()
        eng.warmup()
        setup_s = time.perf_counter() - t0
        rng = np.random.default_rng(SEED)
        prefixes = [rng.integers(1, cfg.vocab_size, pc.block_size).tolist()
                    for _ in range(SHARED_PREFIXES)]

        def wave(count, max_tokens, seed):
            rng = np.random.default_rng(seed)
            rids = []
            for i in range(count):
                pre = (prefixes[(i // 4) % SHARED_PREFIXES]
                       if shared and i % 4 == 0 else [])
                p = pre + rng.integers(1, cfg.vocab_size,
                                       prompt - len(pre)).tolist()
                rids.append(eng.submit_request(GenerationRequest(
                    prompt_tokens=p, max_tokens=max_tokens,
                    temperature=0.0)))
            eng.run_until_done(rids)
            torch.cuda.synchronize()
            return rids

        def warm_wave():
            """Empty the radix cache, then the warm wave: the state every
            measured wave starts from."""
            if eng.radix is not None:
                eng._radix_evict(eng.radix.total_cached_tokens())
                if eng.radix.total_cached_tokens():
                    raise AssertionError(f"{what}: the radix cache kept "
                                         f"{eng.radix.total_cached_tokens()}"
                                         " tokens after evicting them all")
            if warm:
                wave(warm, 16, SEED + 1)

        # host time of the prefill and decode dispatches, each ended by a
        # synchronize (both already wait for the device: the tokens come
        # back)
        spent = {"prefill": 0.0, "decode": 0.0}

        def timed(kind, fn):
            def run(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                spent[kind] += time.perf_counter() - t
                return out
            run.__wrapped__ = fn
            return run

        eng._prefill = timed("prefill", eng._prefill)
        eng._decode = timed("decode", eng._decode)
        torch.cuda.reset_peak_memory_stats()
        walls, spents, lines, warm_s = [], [], [], []
        seen[label] = []
        for _ in range(waves):
            t0 = time.perf_counter()
            warm_wave()
            warm_s.append(time.perf_counter() - t0)
            hits0 = eng.stats()["radix_hit_tokens"]
            pre0 = eng.scheduler.num_preempted
            for k in spent:
                spent[k] = 0.0
            eng.dispatch_trace = []
            reset_launches()
            t0 = time.perf_counter()
            # K5's event pairs and K1's census wrap Python calls: only the
            # eager engine makes them (a replay calls no Python)
            eager = label == "eager"
            with (CallTime(paged_model, "flash_attention") if eager
                  else contextlib.nullcontext()) as k5, \
                    (K1Census() if eager else contextlib.nullcontext()) as k1:
                rids = wave(n, tokens, SEED + 2)
            wall = time.perf_counter() - t0
            counts = read_launches()
            res = [eng.get_result(r) for r in rids]
            seen[label].append(([(r.tokens, r.finish_reason) for r in res],
                                list(eng.dispatch_trace)))
            bad = [r.request_id for r in res if len(r.tokens) != tokens
                   or min(r.tokens) < 0 or max(r.tokens) >= cfg.vocab_size]
            if bad:
                raise AssertionError(f"{what}, {label}: requests with wrong "
                                     f"tokens: {bad[:5]}")
            steps = sum(t[1] for t in eng.dispatch_trace if t[0] == "decode")
            missing = [k for k in expect if counts[k] == 0]
            wrong = [k for k in forbid if counts[k] != 0]
            if missing or wrong or ("fused_paged_decode_step" in expect
                                    and counts["fused_paged_decode_step"]
                                    != steps):
                raise AssertionError(f"{what}, {label}: kernels not launched "
                                     f"as expected ({steps} decode steps): "
                                     f"{counts}")
            # K1: the prefill chunks through wgmma, the decode head through
            # the stream (counted where the dispatches run in Python)
            if eager and "int8_matmul_prefill" in expect and not (
                    k1.launched("wgmma")
                    and k1.launched("stream", cfg.vocab_size)):
                raise AssertionError(f"{what}: K1 routes {k1.report()}")
            if label == "captured":
                total = {k: total[k] + counts[k] for k in KERNELS}
            ttft = sorted(r.ttft_s for r in res)
            hits = eng.stats()["radix_hit_tokens"] - hits0
            preempt = eng.scheduler.num_preempted - pre0
            if shared and hits <= 0:
                raise AssertionError(f"{what}: no radix hit")
            prefills = sum(1 for t in eng.dispatch_trace
                           if t[0] == "prefill")
            walls.append(wall)
            spents.append(dict(spent))
            lines.append(
                f"wall {wall:.3f} s, {n * tokens / wall:.1f} output tok/s, "
                f"{n / wall:.2f} requests/s, TTFT p50 "
                f"{ttft[len(ttft) // 2] * 1e3:.1f} ms p90 "
                f"{ttft[int(len(ttft) * 0.9)] * 1e3:.1f} ms; radix_hit_tokens"
                f" {hits}, preemptions {preempt}; {prefills} prefill and "
                f"{len(eng.dispatch_trace) - prefills} decode dispatches, "
                f"{steps} decode steps; prefill dispatches "
                f"{spent['prefill']:.3f} s, decode dispatches "
                f"{spent['decode']:.3f} s, the rest "
                f"{wall - sum(spent.values()):.3f} s; launches "
                f"{ {k: v for k, v in counts.items() if v} }"
                + (f"; K5 (event pairs around its calls) {k5.ms():.1f} ms; "
                   f"K1 by route and M: {k1.report()}" if eager else ""))
        mid = sorted(range(waves), key=lambda i: walls[i])[waves // 2]
        log(f"{what}, {label} dispatch: {n} requests x prompt {prompt} -> "
            f"{tokens} greedy tokens"
            f"{', every 4th behind a shared prefix' if shared else ''}; "
            f"warmup() {setup_s:.1f} s "
            f"(prefill_compile {eng.stats().get('prefill_compile')}), warm "
            f"waves {warm} requests "
            f"{', '.join(f'{t:.1f}' for t in warm_s)} s; radix cache "
            f"{type(eng.radix).__name__ if eng.radix else 'off'}; median "
            f"wall of {waves}: {walls[mid]:.3f} s (prefill dispatches "
            f"{spents[mid]['prefill']:.3f} s, decode dispatches "
            f"{spents[mid]['decode']:.3f} s); peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; waves: "
            + " | ".join(lines))
        if profiled and label == "captured":
            eng._prefill, eng._decode = eng._prefill.__wrapped__, \
                eng._decode.__wrapped__
            warm_wave()
            profile_wave(lambda: wave(n, tokens, SEED + 2), what, walls[mid])
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    if compare:
        for i, (a, b) in enumerate(zip(seen["captured"], seen["eager"])):
            if a[0] != b[0]:
                raise AssertionError(f"{what}, wave {i}: tokens or finish "
                                     "reasons of the captured engine differ "
                                     "from the eager engine's")
            if a[1] != b[1]:
                j = next((k for k, (u, v) in enumerate(zip(a[1], b[1]))
                          if u != v), min(len(a[1]), len(b[1])))
                raise AssertionError(
                    f"{what}, wave {i}: dispatch_trace of the captured "
                    f"engine differs from the eager engine's at entry {j} "
                    f"of {len(a[1])}/{len(b[1])}: "
                    f"{a[1][j] if j < len(a[1]) else None} against "
                    f"{b[1][j] if j < len(b[1]) else None}; host clock "
                    f"{time.get_clock_info('monotonic')}")
        log(f"{what}: the captured and the eager engine gave identical "
            f"tokens, finish reasons and dispatch_trace in {waves} waves")
    return total


def serving_cfg():
    from physics_llm_inference_tpu_torch.models.config import ModelConfig

    return ModelConfig(num_layers=32, **dict(WIDTHS, max_seq_len=1024))


def bench_wave(dev, params, cfg) -> dict:
    """The paged engine in the bench_serving7b configuration (K8 decode, K5
    prefill, K1 on both routes), a profiled wave after the measured one."""
    return serve(dev, params, cfg, "paged engine, bench_serving7b "
                 "configuration", dict(max_batch=64, kv_dtype="int8",
                                       decode_horizon=8, enable_radix=True,
                                       prefill_tokens_per_iter=2048),
                 SERVE_REQUESTS, SERVE_PROMPT, SERVE_TOKENS,
                 expect=("fused_paged_decode_step", "flash_attention",
                         "int8_matmul", "int8_matmul_prefill"),
                 forbid=("int8_paged_decode_attention",
                         "paged_decode_attention"), shared=True, warm=64,
                 waves=3, compare=True, profiled=True)


def serving_runs(dev, params) -> dict:
    """Phase 5, paged: the bench_serving7b configuration (K8 decode, K5
    prefill), then the per-op routes at full width with fewer requests:
    INT8 pools at block size 16 (K6) and bf16 pools (K7). Returns each
    kernel's launches summed over the measured waves."""
    cfg = serving_cfg()
    small = dict(max_batch=64, block_size=16, max_blocks_per_request=64,
                 num_blocks=64 * 64 + 16, decode_horizon=8,
                 prefill_tokens_per_iter=2048)
    runs = [
        bench_wave(dev, params, cfg),
        serve(dev, params, cfg, "paged engine, per-op route, INT8 pools, "
              "BS=16", dict(small, kv_dtype="int8"), 64, 128, 16,
              expect=("int8_paged_decode_attention", "flash_attention",
                      "int8_matmul"), forbid=("fused_paged_decode_step",)),
        serve(dev, params, cfg, "paged engine, per-op route, bf16 pools, "
              "BS=16", dict(small, kv_dtype=None), 64, 128, 16,
              expect=("paged_decode_attention", "flash_attention",
                      "int8_matmul"),
              forbid=("fused_paged_decode_step",
                      "int8_paged_decode_attention")),
    ]
    return {k: sum(r[k] for r in runs) for k in KERNELS}


# phase 5c, the serving front end: the slot engine behind the HTTP server
FRONT_REQUESTS, FRONT_CLIENTS, FRONT_TOKENS = 128, 32, 64
FRONT_PROMPTS = (32, 576)          # prompt tokens, drawn from a seed
FRONT_TIMEOUT = 300                # seconds a client waits for a response


class CodepointTokenizer:
    """Each character is its code point: injective over the 7B vocab, so a
    response's text gives back its tokens, and a prompt's text is its
    tokens."""

    def encode(self, text: str) -> list[int]:
        return [ord(c) for c in text]

    def decode(self, ids) -> str:
        return "".join(chr(int(i)) for i in ids)


def eager_slot_engine_class():
    """InferenceEngine with its three dispatch functions called eagerly,
    here, not through a switch in the package: the prefill chunk straight
    into the pool's (L, 1, S, ·) view of the slot (no slot buffer), the
    decode horizon and the verify window as plain calls of the step
    functions on fresh device tensors, with no graph."""
    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.runtime.speculative import \
        _verify_window
    from physics_llm_inference_tpu_torch.serve.engine import (
        InferenceEngine, _slot_of_cache, decode_horizon, prefill_chunk)

    class EagerSlotEngine(InferenceEngine):
        def _t(self, a):
            return torch.tensor(np.asarray(a), device=self.device)

        def _prefill(self, slot, ids, pos, n, sampling):
            return prefill_chunk(
                self.params, self.cfg, self._t(ids),
                _slot_of_cache(self._k, slot), _slot_of_cache(self._v, slot),
                self._t(pos), self._t(n), self._rng,
                self._t(np.float32(sampling.temperature)),
                self._t(np.full(1, sampling.top_k, np.int32)),
                self._t(np.float32(sampling.top_p)))

        def _decode(self, horizon, filtered, tokens, lens, temps, top_ks,
                    top_ps):
            return decode_horizon(
                self.params, self.cfg, self._k, self._v, self._t(tokens),
                self._t(lens), self._rng, self._t(temps), self._t(top_ks),
                self._t(top_ps), horizon, filtered).cpu().numpy()

        def _verify(self, window, starts):
            starts = self._t(starts)
            return _verify_window(self.params, self.cfg, self._t(window),
                                  self._k, self._v, starts, starts,
                                  None).cpu().numpy()

    return EagerSlotEngine


def front_contents(seed: int, n: int, lo: int, hi: int, vocab: int):
    """n chat contents whose prompts ("user: " + content, one token a
    character) have lengths drawn in [lo, hi]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    return ["".join(chr(int(c)) for c in rng.integers(1, vocab, int(m) - 6))
            for m in lens]


def prompt_tokens(content: str) -> list[int]:
    """The prompt the server makes of a one-message chat."""
    return CodepointTokenizer().encode(f"user: {content}")


def chat(port: int, content: str, max_tokens: int, stream: bool):
    """One greedy chat request; returns (tokens, finish_reason) read back
    from the response's text (SSE deltas joined when streaming)."""
    import urllib.request

    body = json.dumps({"messages": [{"role": "user", "content": content}],
                       "max_tokens": max_tokens, "temperature": 0.0,
                       "stream": stream}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=FRONT_TIMEOUT) as r:
        if not stream:
            d = json.load(r)
            text = d["choices"][0]["message"]["content"]
            reason = d["choices"][0]["finish_reason"]
            if d["usage"]["completion_tokens"] != len(text):
                raise AssertionError(f"usage {d['usage']} against "
                                     f"{len(text)} characters")
        else:
            events = [e[6:] for e in r.read().decode().split("\n\n")
                      if e.startswith("data: ")]
            if events[-1] != "[DONE]":
                raise AssertionError(f"SSE ended with {events[-1][:80]}")
            chunks = [json.loads(e) for e in events[:-1]]
            text = "".join(c["choices"][0]["delta"].get("content", "")
                           for c in chunks)
            reason = chunks[-1]["choices"][0]["finish_reason"]
    return CodepointTokenizer().encode(text), reason


def client_wave(eng, contents, clients: int, max_tokens: int, what: str,
                http: bool = True, during=None):
    """`clients` client threads send every request of `contents`, each its
    share in turn, waiting for one response before the next: with `http`,
    as chat requests to the engine behind InferenceServer(port=0) on
    127.0.0.1 with the code point tokenizer, every fourth streamed over SSE;
    else straight to the engine (submit_request, then wait_result) under a
    ServingLoop. Then `during(eng, server)`, the server still up. Returns
    the (tokens, finish_reason) of each request in `contents`' order, the
    wall from the first request to the last response, and the engine's
    TTFTs of the wave."""
    import threading

    from physics_llm_inference_tpu_torch.serve.engine import GenerationRequest
    from physics_llm_inference_tpu_torch.serve.http_server import (
        InferenceServer, ServingLoop)
    from physics_llm_inference_tpu_torch.serve.tokenizer_pool import \
        TokenizerPool

    n = len(contents)
    before = set(eng._results)
    got, errors = [None] * n, []
    if http:
        srv = InferenceServer(eng, port=0, tokenizer=TokenizerPool(
            num_workers=4, tokenizer_factory=CodepointTokenizer))
        srv.start_background()
        loop = srv.loop

        def send(i):
            return chat(srv.port, contents[i], max_tokens, stream=i % 4 == 0)
    else:
        srv, loop = None, ServingLoop(eng)

        def send(i):
            rid = eng.submit_request(GenerationRequest(
                prompt_tokens=prompt_tokens(contents[i]),
                max_tokens=max_tokens, temperature=0.0))
            loop.notify()
            res = eng.wait_result(rid, timeout=FRONT_TIMEOUT)
            return res.tokens, res.finish_reason
    try:
        def client(c):
            for i in range(c, n, clients):
                try:
                    got[i] = send(i)
                except Exception as e:  # reported below, with the others
                    errors.append(f"request {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(FRONT_TIMEOUT)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads) or None in got:
            raise AssertionError(f"{what}: {len(errors)} requests failed "
                                 f"(loop thread alive: "
                                 f"{loop._thread.is_alive()}): "
                                 f"{errors[:3]}")
        if during is not None:
            during(eng, srv)
    finally:
        if srv is not None:
            srv.shutdown()
        else:
            loop.shutdown()
    if loop._thread.is_alive():
        raise AssertionError(f"{what}: the serving loop did not stop")
    ttft = sorted(r.ttft_s for k, r in eng._results.items()
                  if k not in before and r.ttft_s is not None)
    return got, wall, ttft


def direct_run(eng, prompts, max_tokens: int):
    """Every prompt submitted to the engine at once, run to the end on this
    thread. Returns (results, dispatch_trace, wall)."""
    import torch

    from physics_llm_inference_tpu_torch.serve.engine import GenerationRequest

    eng.dispatch_trace = []
    t0 = time.perf_counter()
    rids = [eng.submit_request(GenerationRequest(
        prompt_tokens=p, max_tokens=max_tokens, temperature=0.0))
        for p in prompts]
    eng.run_until_done(rids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([eng.get_result(r) for r in rids], list(eng.dispatch_trace),
            wall)


def same_run(a, b, what: str) -> None:
    """Two direct runs' tokens, finish reasons and dispatch traces equal."""
    (ra, ta, _), (rb, tb, _) = a, b
    if [(r.tokens, r.finish_reason) for r in ra] != \
            [(r.tokens, r.finish_reason) for r in rb]:
        bad = [i for i, (x, y) in enumerate(zip(ra, rb))
               if (x.tokens, x.finish_reason) != (y.tokens, y.finish_reason)]
        raise AssertionError(f"{what}: tokens or finish reasons differ at "
                             f"requests {bad[:8]} of {len(ra)}")
    if ta != tb:
        j = next((k for k, (u, v) in enumerate(zip(ta, tb)) if u != v),
                 min(len(ta), len(tb)))
        raise AssertionError(f"{what}: dispatch_trace differs at entry {j} "
                             f"of {len(ta)}/{len(tb)}")


def pct(vals, q: float) -> float:
    return vals[min(len(vals) - 1, int(len(vals) * q))]


def full_horizon_ms(eng, cfg) -> list:
    """ms a step of each decode dispatch with every slot decoding at the
    full horizon: num_slots requests of prompt 128 for 64 tokens, each
    dispatch ended by its tokens' read-back."""
    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.serve.engine import GenerationRequest

    c = eng.config
    rng = np.random.default_rng(SEED + 11)
    decode, seen = eng._decode, []

    def timed(h, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode(h, *a)
        seen.append((h, len(eng.dispatch_trace[-1][3]),
                     (time.perf_counter() - t) * 1e3 / h))
        return out

    eng._decode = timed
    eng.dispatch_trace = []
    try:
        rids = [eng.submit_request(GenerationRequest(
            prompt_tokens=rng.integers(1, cfg.vocab_size, 128).tolist(),
            max_tokens=64, temperature=0.0)) for _ in range(c.num_slots)]
        eng.run_until_done(rids)
    finally:
        del eng._decode
    return [ms for h, rows, ms in seen
            if h == c.decode_horizon and rows == c.num_slots]


def slot_frontend(dev, params, cfg, step_ms) -> dict:
    """Phase 5c, slot engine: warmup() on this thread, then the HTTP wave
    (K1, K4 and K5 launched, K4 once a decode step), the same requests
    submitted directly (the HTTP wall against the direct one), a full
    64-slot horizon's ms a step, then the engine with eager dispatch
    functions on the same requests: tokens, finish reasons and
    dispatch_trace identical to the captured engine's direct run, and every
    HTTP response's tokens equal to the eager engine's for its request.
    Returns the HTTP wave's launch counts."""
    import gc

    import torch

    from physics_llm_inference_tpu_torch.serve.engine import (EngineConfig,
                                                              InferenceEngine)

    what = "front end, slot engine"
    kw = dict(num_slots=64, max_seq_len=1024, kv_dtype="int8",
              decode_horizon=8)
    contents = front_contents(SEED + 9, FRONT_REQUESTS, *FRONT_PROMPTS,
                              cfg.vocab_size)
    prompts = [prompt_tokens(c) for c in contents]
    eng = InferenceEngine(params, cfg, EngineConfig(**kw))
    setup_s = eng.warmup()
    direct = direct_run(eng, prompts, FRONT_TOKENS)
    eng.dispatch_trace = []
    reset_launches()
    got, wall, ttft = client_wave(eng, contents, FRONT_CLIENTS, FRONT_TOKENS,
                                  what)
    counts = read_launches()
    steps = sum(t[1] for t in eng.dispatch_trace if t[0] == "decode")
    chunks = [t for t in eng.dispatch_trace if t[0] == "prefill"]
    eng.dispatch_trace = []
    closed, closed_wall, closed_ttft = client_wave(
        eng, contents, FRONT_CLIENTS, FRONT_TOKENS, what, http=False)
    closed_steps = sum(t[1] for t in eng.dispatch_trace if t[0] == "decode")
    direct_steps = sum(t[1] for t in direct[1] if t[0] == "decode")
    missing = [k for k in ("int8_matmul", "int8_matmul_prefill",
                           "fused_decode_step", "flash_attention")
               if counts[k] == 0]
    wrong = [k for k in ("int8_kv_decode_attention", "lmhead_greedy",
                         "fused_paged_decode_step") if counts[k]]
    if missing or wrong or counts["fused_decode_step"] != steps:
        raise AssertionError(f"{what}: kernels not launched as expected "
                             f"({steps} decode steps): {counts}")
    full = full_horizon_ms(eng, cfg)
    if not full:
        raise AssertionError(f"{what}: no full-horizon dispatch")
    stats = eng.stats()
    json.dumps(stats)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    eager = eager_slot_engine_class()(params, cfg, EngineConfig(**kw))
    plain = direct_run(eager, prompts, FRONT_TOKENS)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    same_run(direct, plain, f"{what}: captured against eager dispatch")
    want = [(r.tokens, r.finish_reason) for r in plain[0]]
    if closed != want:
        raise AssertionError(f"{what}: the closed-loop direct wave's tokens "
                             "differ from the eager engine's")
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad:
        i = bad[0]
        pos = next((j for j, (a, b) in enumerate(zip(got[i][0], want[i][0]))
                    if a != b), None)
        raise AssertionError(f"{what}: {len(bad)} HTTP responses differ from "
                             f"the eager engine's tokens (request {i}, "
                             f"first at position {pos}, finish "
                             f"{got[i][1]}/{want[i][1]})")
    if any(len(t) != FRONT_TOKENS for t, _ in got):
        raise AssertionError(f"{what}: a response without {FRONT_TOKENS} "
                             "tokens")
    n_tok = FRONT_REQUESTS * FRONT_TOKENS
    full.sort()
    log(f"{what} ({nvidia_smi()}): 64 slots x 1,024 positions, INT8 pool, "
        f"horizon 8; warmup() {setup_s:.1f} s (prefill_compile "
        f"{stats['prefill_compile']}); HTTP wave of {FRONT_REQUESTS} chat "
        f"requests from {FRONT_CLIENTS} client threads (every 4th SSE), "
        f"prompts {FRONT_PROMPTS[0]}-{FRONT_PROMPTS[1]}, {FRONT_TOKENS} "
        f"greedy tokens: wall {wall:.3f} s, {FRONT_REQUESTS / wall:.2f} "
        f"requests/s, {n_tok / wall:.1f} output tok/s, TTFT p50 "
        f"{pct(ttft, 0.5) * 1e3:.1f} ms p90 {pct(ttft, 0.9) * 1e3:.1f} ms; "
        f"{len(chunks)} prefill chunks, {steps} decode steps; the same "
        f"requests from {FRONT_CLIENTS} threads straight to the engine (no "
        f"HTTP): wall {closed_wall:.3f} s, {n_tok / closed_wall:.1f} tok/s, "
        f"TTFT p50 {pct(closed_ttft, 0.5) * 1e3:.1f} ms p90 "
        f"{pct(closed_ttft, 0.9) * 1e3:.1f} ms, {closed_steps} decode steps; "
        f"all submitted at once: wall {direct[2]:.3f} s "
        f"({n_tok / direct[2]:.1f} tok/s, {direct_steps} decode steps), "
        f"eager dispatch {plain[2]:.3f} s; "
        f"full 64-slot horizon: {pct(full, 0.5):.3f} ms a step (median of "
        f"{len(full)}, {full[0]:.3f}-{full[-1]:.3f}), cached_generate's "
        f"phase-5 step {'%.3f ms' % step_ms if step_ms else 'not measured'}"
        f"; launches {({k: v for k, v in counts.items() if v})}; captured "
        "and eager engines identical (tokens, finish reasons, "
        "dispatch_trace), every HTTP response's tokens equal to the eager "
        "engine's")
    return counts


def spec_frontend(dev, params, cfg) -> dict:
    """Phase 5c, speculative: 16 greedy requests of repetitive prompts (a
    phrase of 8-24 tokens repeated to 96-256) through the slot engine with
    speculative_k=4, captured and eager (identical tokens, finish reasons
    and dispatch_trace), then through the plain engine: the drafts
    accepted a dispatch, and the share of requests whose tokens equal the
    plain engine's (the verify window's per-op route and K4 round apart).
    Returns the captured run's launch counts."""
    import gc

    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.serve.engine import (EngineConfig,
                                                              InferenceEngine)

    what = "front end, speculative_k=4"
    kw = dict(num_slots=16, max_seq_len=1024, kv_dtype="int8",
              decode_horizon=8)
    rng = np.random.default_rng(SEED + 12)
    prompts = []
    for _ in range(16):
        phrase = rng.integers(1, cfg.vocab_size, int(rng.integers(8, 25)))
        prompts.append(np.resize(phrase, int(rng.integers(96, 257))).tolist())
    runs = {}
    for label, cls, k in (("captured", InferenceEngine, 4),
                          ("eager", eager_slot_engine_class(), 4),
                          ("plain", InferenceEngine, 0)):
        eng = cls(params, cfg, EngineConfig(speculative_k=k, **kw))
        if label != "eager":
            eng.warmup()
        reset_launches()
        runs[label] = direct_run(eng, prompts, FRONT_TOKENS)
        if label == "captured":
            counts = read_launches()
            spec = eng.stats()["speculative"]
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    same_run(runs["captured"], runs["eager"], f"{what}: captured against "
             "eager dispatch")
    kinds = [t[0] for t in runs["captured"][1]]
    if "spec" not in kinds or counts["int8_matmul_prefill"] == 0:
        raise AssertionError(f"{what}: no verify window ran through K1 "
                             f"({kinds.count('spec')} windows; {counts})")
    first = []
    for a, b in zip(runs["captured"][0], runs["plain"][0]):
        first.append(next((j for j, (x, y) in enumerate(zip(a.tokens,
                                                             b.tokens))
                           if x != y), None))
    equal = sum(f is None for f in first)
    log(f"{what} ({nvidia_smi()}): 16 slots, 16 requests of repetitive "
        f"prompts, {FRONT_TOKENS} greedy tokens: {kinds.count('spec')} "
        f"verify windows, {spec['tokens_per_dispatch']:.3f} tokens a request "
        f"a dispatch ({spec['tokens_per_dispatch'] - 1:.3f} drafts accepted "
        f"beside the bonus token); wall {runs['captured'][2]:.3f} s against "
        f"the plain engine's {runs['plain'][2]:.3f} s; captured and eager "
        f"identical; requests with the plain engine's tokens: {equal} of "
        f"{len(first)}, first differing position of the others: "
        f"{[f for f in first if f is not None]}; launches "
        f"{({k: v for k, v in counts.items() if v})}")
    return counts


def paged_frontend(dev, params, cfg) -> dict:
    """Phase 5c, paged: the paged engine in phase 5's bench_serving7b
    geometry behind the same server, with no warmup(), as the CLI serves:
    every step is captured on the serving loop's thread at its first use.
    64 chat requests (K8, K5, K1), then abort_request on a running request,
    which must finish "aborted" (the reference's reason). Returns the
    wave's launch counts."""
    import gc

    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.serve.engine import GenerationRequest
    from physics_llm_inference_tpu_torch.serve.paged_engine import (
        PagedEngineConfig, PagedInferenceEngine)

    what = "front end, paged engine"
    eng = PagedInferenceEngine(params, cfg, PagedEngineConfig(
        max_batch=64, kv_dtype="int8", decode_horizon=8, enable_radix=True,
        prefill_tokens_per_iter=2048))
    contents = front_contents(SEED + 10, 64, *FRONT_PROMPTS, cfg.vocab_size)
    aborted = {}

    def abort_one(eng, srv):
        rid = eng.submit_request(GenerationRequest(
            prompt_tokens=np.arange(1, 129).tolist(), max_tokens=512,
            temperature=0.0))
        srv.loop.notify()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < FRONT_TIMEOUT:
            r = eng.scheduler.running.get(rid)
            if r is not None and len(r.output_tokens) >= 8:
                break
            time.sleep(0.005)
        aborted["ok"] = eng.abort_request(rid)
        aborted["res"] = eng.wait_result(rid, timeout=FRONT_TIMEOUT)

    reset_launches()
    eng.dispatch_trace = []
    got, wall, ttft = client_wave(eng, contents, 16, FRONT_TOKENS, what,
                                  during=abort_one)
    counts = read_launches()
    res = aborted.get("res")
    if not (aborted.get("ok") and res is not None
            and res.finish_reason == "aborted"
            and 8 <= len(res.tokens) < 512):
        raise AssertionError(f"{what}: abort_request on a running request "
                             f"gave {aborted}")
    if counts["fused_paged_decode_step"] == 0 or counts["flash_attention"] \
            == 0 or counts["int8_matmul"] == 0 or any(
            counts[k] for k in ("int8_paged_decode_attention",
                                "paged_decode_attention",
                                "fused_decode_step")):
        raise AssertionError(f"{what}: kernels not launched as expected: "
                             f"{counts}")
    if any(len(t) != FRONT_TOKENS or f != "length" for t, f in got):
        raise AssertionError(f"{what}: a response without {FRONT_TOKENS} "
                             "tokens")
    n_tok = 64 * FRONT_TOKENS
    log(f"{what} ({nvidia_smi()}): bench_serving7b geometry, no warmup() "
        f"(the loop thread captured {eng.stats()['prefill_compile']} "
        f"prefill buckets and {len(eng._decode_fns)} decode steps); 64 chat "
        f"requests from 16 clients: wall {wall:.3f} s, "
        f"{n_tok / wall:.1f} output tok/s, TTFT p50 "
        f"{pct(ttft, 0.5) * 1e3:.1f} ms p90 {pct(ttft, 0.9) * 1e3:.1f} ms; "
        f"abort_request on a running request: finish_reason "
        f"{res.finish_reason!r} after {len(res.tokens)} tokens; launches "
        f"{({k: v for k, v in counts.items() if v})}")
    # the first wave's wall holds its captures: a second wave of fresh
    # prompts replays what the first captured, and says what it added
    made = (eng.stats()["prefill_compile"]["misses"], len(eng._decode_fns))
    again = front_contents(SEED + 11, 64, *FRONT_PROMPTS, cfg.vocab_size)
    got, wall2, ttft2 = client_wave(eng, again, 16, FRONT_TOKENS,
                                    what + ", second wave")
    if any(len(t) != FRONT_TOKENS or f != "length" for t, f in got):
        raise AssertionError(f"{what}, second wave: a response without "
                             f"{FRONT_TOKENS} tokens")
    new = (eng.stats()["prefill_compile"]["misses"] - made[0],
           len(eng._decode_fns) - made[1])
    log(f"{what}, second wave of 64 fresh prompts ({nvidia_smi()}): wall "
        f"{wall2:.3f} s, {n_tok / wall2:.1f} output tok/s, TTFT p50 "
        f"{pct(ttft2, 0.5) * 1e3:.1f} ms p90 {pct(ttft2, 0.9) * 1e3:.1f} "
        f"ms; captures made in it: {new[0]} prefill buckets, {new[1]} "
        f"decode steps (first wave: {made[0]} prefill buckets, {made[1]} "
        f"decode steps)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def cli_check():
    """`cli serve --config llama7b --int8 --check` on the card."""
    import gc

    import torch

    from physics_llm_inference_tpu_torch import cli

    t0 = time.perf_counter()
    cli.main(["serve", "--config", "llama7b", "--int8", "--check",
              "--port", "0"])
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"front end, cli serve --config llama7b --int8 --check --port 0: "
        f"ok in {time.perf_counter() - t0:.1f} s")


def frontend_runs(dev, params, step_ms=None) -> dict:
    """Phase 5c: the slot engine behind the HTTP server, the speculative
    engine, the paged engine behind the server, the CLI's serve check.
    Returns the launches of the slot and paged HTTP waves and of the
    captured speculative run."""
    cfg = serving_cfg()
    t0 = time.perf_counter()
    runs = [slot_frontend(dev, params, cfg, step_ms),
            spec_frontend(dev, params, cfg),
            paged_frontend(dev, params, cfg)]
    cli_check()
    log(f"phase 5c (front end): {time.perf_counter() - t0:.1f} s")
    return {k: sum(r[k] for r in runs) for k in KERNELS}


def frontend_alone(dev):
    """--frontend: phase 5c alone, on the INT8 7B-class weights."""
    import torch

    from physics_llm_inference_tpu_torch.models.quant import init_params_int8

    cfg = serving_cfg()
    frontend_runs(dev, init_params_int8(
        torch.Generator(device=dev).manual_seed(SEED), cfg))


SUITE_KEYS = ("mha_vs_gqa", "swiglu_fusion", "naive_vs_cached", "gemm",
              "gemv_bf16", "gemv_int8", "attn_flash", "attn_naive",
              "static_batching")


def fractions(tree):
    """Every roofline_fraction in a nested result."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "roofline_fraction":
                yield v
            else:
                yield from fractions(v)


def micro_path(dev) -> dict:
    """Phase 6: the microbenchmark path through its public functions at the
    JAX package's default sizes, then the suite in full. Returns the launch
    counts of the run."""
    import math

    import torch

    from physics_llm_inference_tpu_torch.bench import micro, suite
    from physics_llm_inference_tpu_torch.kernels.hello_pallas import \
        vector_add
    from physics_llm_inference_tpu_torch.kernels.membench import \
        measure_access_patterns

    t0 = time.perf_counter()
    reset_launches()
    res = {
        "gemm_kernel": micro.bench_gemm(use_kernel=True),
        "gemm": micro.bench_gemm(),
        "gemv_bf16": micro.bench_gemv(8, 4096, 4096),
        "gemv_int8": micro.bench_gemv(8, 4096, 4096, int8_weights=True),
        "attn_flash": micro.bench_attention(seq=2048),
        "attn_naive": micro.bench_attention(seq=2048, use_flash=False),
        "precision": micro.bench_precision(),
        "access_patterns": measure_access_patterns(),
    }
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    a = torch.randn((524288, 128), generator=g, device=dev)
    if not torch.equal(vector_add(a, a), a + a):
        raise AssertionError("phase 6: vector_add differs from a + a")
    for name, r in res.items():
        log(f"phase 6 {name}: {json.dumps(r, default=float)}")
    log(micro.roofline_report([res[k] for k in ("gemm_kernel", "gemm",
                                                "gemv_bf16", "gemv_int8",
                                                "attn_flash", "attn_naive")]))
    res["suite"] = suite.main([])
    counts = read_launches()
    log(f"phase 6 (microbenchmark path): {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}")
    missing = [k for k in MICRO_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"phase 6: kernels not launched: {missing}")
    if set(res["suite"]) != set(SUITE_KEYS):
        raise AssertionError(f"phase 6: suite keys {sorted(res['suite'])}")
    values = list(fractions(res))
    if not values or not all(math.isfinite(v) and 0 < v <= 1.05
                             for v in values):
        raise AssertionError(f"phase 6: roofline fractions {values} outside "
                             "(0, 1.05]: the bytes or operations counted are "
                             "wrong")
    return counts


def serving_alone(dev):
    """The first of serving_runs alone: the bench_serving7b wave, with K1's
    census and the profiled wave."""
    import torch

    from physics_llm_inference_tpu_torch.models.quant import init_params_int8

    cfg = serving_cfg()
    bench_wave(dev, init_params_int8(
        torch.Generator(device=dev).manual_seed(SEED), cfg), cfg)


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG} not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    log(nvidia_smi())
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")

    from physics_llm_inference_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    reports = {}
    _build.build(ptxas=reports)
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.LIB_PATH}")
    for line in ptxas_report(reports):
        log(line)

    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    if set(argv) & {"--k1", "--attention", "--fused", "--decode",
                    "--serving", "--frontend", "--copy"}:
        # parts alone, for comparing trees: K1 in phase 3; K2, K6 and K7
        # in phase 3; K4 in each mode, K8 and the phase clock; decode at
        # prompt 128 in each K4 mode; the bench_serving7b wave
        if "--attention" in argv:
            check_k2(dev, flush, torch.Generator(device=dev).manual_seed(SEED))
            check_paged_attention(dev, flush)
        if "--k1" in argv:
            check_k1(dev, flush, torch.Generator(device=dev).manual_seed(SEED))
            check_k3(dev, flush, torch.Generator(device=dev).manual_seed(SEED))
        if "--copy" in argv:
            check_teaching(dev, flush)
        if "--fused" in argv:
            for mode in FUSED_MODES:
                check_fused(dev, flush, mode)
            fused_seeds(dev, flush)
            check_fused_capture(dev)
            check_fused_paged(dev, flush)
        del flush
        torch.cuda.empty_cache()
        if "--fused" in argv:
            phase_clock(dev)
        if "--decode" in argv:
            decode_alone(dev)
        if "--serving" in argv:
            serving_alone(dev)
        if "--frontend" in argv:
            frontend_alone(dev)
        log(nvidia_smi())
        return 0
    kernels = check_kernels(dev, flush)
    del flush
    torch.cuda.empty_cache()
    phase_clock(dev)
    slice_parity(dev, fused=False)
    for mode in FUSED_MODES:
        slice_parity(dev, fused=True, mode=mode)
    paged_slice_parity(dev)
    torch.cuda.empty_cache()
    dense, params, step_ms = full_runs(dev)
    paged = serving_runs(dev, params)
    front = frontend_runs(dev, params, step_ms)
    del params
    torch.cuda.empty_cache()
    micro = micro_path(dev)
    counts = {k: dense[k] + paged[k] + front[k] + micro[k] for k in KERNELS}

    rows = []
    for name, row in kernels.items():
        _, _, src, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": f"{PKG}/{src}",
                     "replaces": replaces, "launches": counts[name], **row})
    log(nvidia_smi())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
