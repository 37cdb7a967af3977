#!/usr/bin/env python3
"""Smoke run of the PyTorch port (physics_llm_inference_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no final line):
1. device: the card's name and power limit (nvidia-smi); no CUDA -> fail;
2. build: nvcc compiles csrc/*.cu into build/, one process per source, all
   in parallel (kernels/_build.py);
3. each CUDA kernel (K1 int8_matmul, K2 int8_kv_decode_attention, K3
   lmhead_greedy, K4 fused_decode_step, K5 flash_attention, K6
   int8_paged_decode_attention, K7 paged_decode_attention, K8
   fused_paged_decode_step, K9 tiled_matmul, K10 stream_copy, K11
   strided_copy, K12 vector_add) against its plain torch version at the main
   paths' shapes, with the tolerance stated, and both timed with CUDA
   events, beside the kernel's bound at that shape and, where one PyTorch
   call computes the same function, that call's time;
4. slice parity: a model at the 7B widths with 2 layers runs prefill plus 8
   teacher-forced decode steps with the kernels and again with the kernels'
   entry points swapped for their plain versions (here, not in the package),
   on the per-op and the fused dense decode paths and on the paged path in
   the paged engine's default geometry (chunked flash prefill into INT8
   block pools, fused paged decode); final hidden states or logits and
   greedy tokens are compared;
5. the main paths at full size, on the 7B-class config (32 layers)
   initialized on the card from a seed: cached_generate at batch 64 with 128
   greedy tokens over an INT8 KV cache in the default ModelConfig at prompt
   128 and 512, then on the per-op decode path (K2); then the paged serving
   engine in the scripts/bench_serving7b.py configuration (INT8 pools, 512-
   token blocks, batch 64, horizon 8, radix on) serving 128 requests of
   prompt 576 (every fourth behind one of 8 shared 512-token prefixes) for 64
   greedy tokens each after a warm wave, which decodes through K8; then its
   per-op routes, INT8 pools at block size 16 (K6) and bf16 pools (K7). Every
   kernel of each path must have launched during that path's timed run;
6. the kernel microbenchmark path at the JAX package's default sizes, through
   its public functions: bench_gemm with K9 and with torch.matmul (4096^3
   bf16), bench_gemv (8 x 4096 x 4096, bf16 and K1 int8), bench_attention
   (seq 2048, K5 and the grouped SDPA), bench_precision,
   measure_access_patterns (K10, K11), vector_add (K12), then
   bench.suite.main in full. K9-K12, K1 and K5 must have launched, the
   suite must give the JAX suite's keys, and no roofline_fraction may
   exceed 1.05.
Then one JSON line with each kernel's numbers (launches summed over the
timed runs of phases 5 and 6), and the last line
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
    "int8_matmul": ("int8_matmul", "launches", "csrc/int8_matmul.cu",
                    "physics_llm_inference_tpu/kernels/int8_matmul.py:52"),
    "int8_kv_decode_attention": (
        "int8_kv_attention", "launches", "csrc/int8_kv_attention.cu",
        "physics_llm_inference_tpu/kernels/int8_kv_attention.py:148"),
    "lmhead_greedy": ("lmhead", "launches", "csrc/lmhead.cu",
                      "physics_llm_inference_tpu/kernels/lmhead.py:92"),
    "fused_decode_step": (
        "fused_decode", "launches", "csrc/fused_decode.cu",
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


def row_rel(a, b) -> float:
    """Row-wise relative error ||a - b|| / ||b||, the worst row."""
    return float(((a - b).norm(dim=-1)
                  / b.norm(dim=-1).clamp_min(1e-30)).max())


def entry(err, ms, pms, nbytes, flops, peak="bf16", library_ms=None) -> dict:
    """A kernel's row: its numbers, and its bound at the row's shape: the
    larger of the bytes it must move (each input read once, each output
    written once) over the H100 SXM's 3.35 TB/s and its operations over the
    data-sheet peak of their type (bf16 989 TFLOP/s, f32 67)."""
    from physics_llm_inference_tpu_torch.specs.gpu import H100_SXM as spec

    t_bytes = nbytes / spec.hbm_bandwidth * 1e3
    rate = {"bf16": spec.peak_flops, "fp32": spec.fp32_tflops * 1e12}[peak]
    t_ops = flops / rate * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def int8pack_ms(x, wq, s, want, flush):
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
    return time_ms(lambda: torch._weight_int8pack_mm(x, wt, sc), flush)


def check_kernels(dev, flush) -> dict:
    """Phase 3. Returns {kernel: entry}."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import int8_kv_attention as ka
    from physics_llm_inference_tpu_torch.kernels import int8_matmul as km
    from physics_llm_inference_tpu_torch.kernels import lmhead as kh

    g = torch.Generator(device=dev).manual_seed(SEED)
    d, f, v = WIDTHS["hidden_dim"], WIDTHS["intermediate_dim"], \
        WIDTHS["vocab_size"]
    hq, hkv = WIDTHS["num_heads"], WIDTHS["num_kv_heads"]
    hd = d // hq
    out = {}

    # K1: the four block linears (one decode layer) and the lm_head at
    # M = 64, stacked with a layer index; plus a ragged M and N
    shapes = {"wqkv": (64, d, (hq + 2 * hkv) * hd), "wo": (64, hq * hd, d),
              "w_gate_up": (64, d, 2 * f), "w_down": (64, f, d),
              "lm_head": (64, d, v), "ragged": (7, d, (hq + 2 * hkv) * hd + 64)}
    k1_err, k1_ms, k1_plain, k1_lib = 0.0, 0.0, 0.0, 0.0
    k1_bytes = k1_flops = 0
    for name, (m, k, n) in shapes.items():
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        wq = torch.randint(-127, 128, (2, k, n), dtype=torch.int8,
                           generator=g, device=dev)
        s = torch.rand((2, 1, n), generator=g, device=dev) * 2 / (73.9 * k ** 0.5)
        got = km.int8_matmul(x, wq, s, layer=1).float()
        want = km.int8_matmul_plain(x, wq, s, layer=1).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        # rtol 1e-2: a different f32 summation order, then one bf16 round;
        # atol 1e-3 of the output's scale for entries that cancel to ~0
        bound = 1e-2 * want.abs() + 1e-3 * float(want.abs().max())
        if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
            raise AssertionError(f"K1 {name} ({m},{k},{n}): max err "
                                 f"{float(err.max()):.4g} exceeds rtol 1e-2")
        ms = time_ms(lambda: km.int8_matmul(x, wq, s, layer=1), flush)
        pms = time_ms(lambda: km.int8_matmul_plain(x, wq, s, layer=1), flush)
        gbs = k * n / ms / 1e6
        log(f"K1 int8_matmul {name:9s} M={m} K={k} N={n}: max_abs_err "
            f"{float(err.max()):.4g} (rtol 1e-2), kernel {ms:.4f} ms "
            f"({gbs:.0f} GB/s of weights), plain {pms:.4f} ms")
        k1_err = max(k1_err, float(err.max()))
        if name in ("wqkv", "wo", "w_gate_up", "w_down"):
            k1_ms += ms
            k1_plain += pms
            k1_bytes += nbytes(x, wq[1], s[1]) + m * n * 2
            k1_flops += 2 * m * k * n
            lib = int8pack_ms(x, wq[1], s[1], want, flush) \
                if k1_lib is not None else None
            k1_lib = None if lib is None else k1_lib + lib
    log(f"K1 one decode layer (wqkv+wo+gate_up+down): kernel {k1_ms:.4f} ms, "
        f"plain {k1_plain:.4f} ms, torch._weight_int8pack_mm "
        f"{'none' if k1_lib is None else f'{k1_lib:.4f} ms'}")
    out["int8_matmul"] = entry(k1_err, k1_ms, k1_plain, k1_bytes, k1_flops,
                               library_ms=k1_lib)

    # K2 at B=64, S=256, Hq=32, Hkv=8, d=128, ragged q_slot / valid_from
    L, B, S = 2, 64, 256
    q = torch.randn((B, hq, hd), generator=g, device=dev).bfloat16()
    kq = torch.randint(-127, 128, (L, B, S, hkv * hd), dtype=torch.int8,
                       generator=g, device=dev)
    vq = torch.randint(-127, 128, (L, B, S, hkv * hd), dtype=torch.int8,
                       generator=g, device=dev)
    ks = torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.03
    vs = torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.03
    qslot = torch.randint(128, S, (B,), generator=g, device=dev).int()
    vfrom = torch.randint(0, 128, (B,), generator=g, device=dev).int()
    args = (q, kq, ks, vq, vs, qslot, vfrom)
    got = ka.int8_kv_decode_attention(*args, layer=1).float()
    want = ka.int8_kv_decode_attention_plain(*args, layer=1).float()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > 2e-2:
        raise AssertionError(f"K2: max abs err {err:.4g} > 2e-2")
    ms = time_ms(lambda: ka.int8_kv_decode_attention(*args, layer=1), flush)
    pms = time_ms(lambda: ka.int8_kv_decode_attention_plain(*args, layer=1),
                  flush)
    live = int((qslot - vfrom + 1).sum()) * hkv * hd * 2
    log(f"K2 int8_kv_decode_attention B={B} S={S} Hq={hq} Hkv={hkv} d={hd}: "
        f"max_abs_err {err:.4g} (atol 2e-2), kernel {ms:.4f} ms "
        f"({live / ms / 1e6:.0f} GB/s of live KV), plain {pms:.4f} ms")
    keys = int((qslot - vfrom + 1).sum())  # live keys, one layer
    out["int8_kv_decode_attention"] = entry(
        err, ms, pms, keys * hkv * (2 * hd + 2 * 4) + 2 * nbytes(q)
        + nbytes(qslot, vfrom), 4 * hq * hd * keys)

    # K3 at B=64, D=4096, V=32000: the kernel's token must carry a plain
    # logit within one bf16 ulp of the plain row maximum
    x = torch.randn((64, d), generator=g, device=dev).bfloat16()
    nw = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).bfloat16()
    lq = torch.randint(-127, 128, (d, v), dtype=torch.int8, generator=g,
                       device=dev)
    ls = torch.rand((1, v), generator=g, device=dev) * 2 / (73.9 * d ** 0.5)
    tok = kh.lmhead_greedy(x, nw, lq, ls, eps=1e-6).long()
    ptok = kh.lmhead_greedy_plain(x, nw, lq, ls, eps=1e-6).long()
    from physics_llm_inference_tpu_torch.ops.norms import rms_norm

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
    out["lmhead_greedy"] = entry(err, ms, pms, nbytes(x, nw, lq, ls, tok.int()),
                                 2 * 64 * d * v)
    out["fused_decode_step"] = check_fused(dev, flush)
    out["flash_attention"] = check_flash(dev, flush)
    out.update(check_paged_attention(dev, flush))
    out["fused_paged_decode_step"] = check_fused_paged(dev, flush)
    out.update(check_teaching(dev, flush))
    return out


def fused_bound(blocks, x, L, hkv, hd, hq, read_keys, written):
    """(bytes, flops) of one fused decode step: every weight, scale and
    norm once, the live K/V codes and scales read, the new ones written,
    x in and out."""
    wts = [blocks[n] for n in ("wqkv", "wo", "w_gate_up", "w_down")]
    weights = sum(nbytes(w.q, w.s) for w in wts) + nbytes(blocks["ln1"],
                                                          blocks["ln2"])
    per_key = L * hkv * (2 * hd + 2 * 4)
    flops = 2 * x.shape[0] * sum(w.q[0].numel() for w in wts) * L \
        + 4 * hq * hd * L * (read_keys + written)
    return (weights + per_key * (read_keys + written) + 2 * nbytes(x),
            flops)


def check_fused(dev, flush):
    """K4 at the 7B widths, 2 layers, B = 64, S = 256, ragged valid_from,
    the generate path's in-place write at slot == q_slot. Returns its
    entry (max_abs_err of x_out)."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import fused_decode as kf
    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import init_params_int8
    from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies

    cfg = ModelConfig(num_layers=2, **WIDTHS)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    blocks = init_params_int8(g, cfg)["blocks"]
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
    kw = dict(slot=slot, write_cache=True)
    got_c = [t.clone() for t in cache]
    want_c = [t.clone() for t in cache]
    got = kf.fused_decode_step(blocks, x, *got_c, *args, **kw)[0].float()
    want = kf.fused_decode_step_plain(blocks, x, *want_c, *args,
                                      **kw)[0].float()
    torch.cuda.synchronize()
    rel = row_rel(got, want)
    if not bool(torch.isfinite(got).all()) or rel > 2e-2:
        raise AssertionError(f"K4: x_out row-wise relative error {rel:.4g} "
                             "> 2e-2")
    for i, name in enumerate(("k", "k scale", "v", "v scale")):
        a, b, c = got_c[i], want_c[i], cache[i]
        keep = torch.ones(S, dtype=torch.bool, device=dev)
        keep[slot] = False
        outside = (a[:, :, keep] if a.dtype == torch.int8
                   else a[..., keep])
        ref = c[:, :, keep] if a.dtype == torch.int8 else c[..., keep]
        if not torch.equal(outside, ref):
            raise AssertionError(f"K4: {name} cache changed outside the slot")
    codes = []
    for i, name in ((0, "k"), (2, "v")):
        a = got_c[i][:, :, slot].int()
        b = want_c[i][:, :, slot].int()
        d = (a - b).abs()
        l0 = float((d[0] == 0).float().mean())
        deep = float((d[1:] <= 1).float().mean())
        # layer 0 sees the same input, but the kernel's f32 sums (WMMA
        # tiles, k-splits) and the plain version's (cuBLAS) run in other
        # orders, so a bf16 rounding of qkv can flip: one level, rarely
        if int(d[0].max()) > 1 or l0 < 0.999 or deep < 0.99:
            raise AssertionError(f"K4: {name} codes: layer 0 max diff "
                                 f"{int(d[0].max())}, equal {l0:.5f}; deeper "
                                 f"within one level {deep:.5f}")
        codes.append(f"{name} layer-0 codes equal {l0:.5f}, deeper within "
                     f"one level {deep:.5f}")
    for i in (1, 3):
        sr = ((got_c[i][..., slot] - want_c[i][..., slot]).abs()
              / want_c[i][..., slot].abs()).max()
        codes.append(f"scale rel err {float(sr):.3g}")
    # fixed-order sums, no float atomics: a second launch on the same
    # inputs gives the same bits
    again_c = [t.clone() for t in cache]
    again = kf.fused_decode_step(blocks, x, *again_c, *args, **kw)[0].float()
    if not torch.equal(again, got) or not all(
            torch.equal(a, b) for a, b in zip(again_c, got_c)):
        raise AssertionError("K4: two launches on the same inputs differ")
    err = float((got - want).abs().max())
    ms = time_ms(lambda: kf.fused_decode_step(blocks, x, *got_c, *args, **kw),
                 flush)
    pms = time_ms(lambda: kf.fused_decode_step_plain(blocks, x, *want_c,
                                                     *args, **kw), flush)
    wbytes = sum(blocks[n].q.numel() for n in ("wqkv", "wo", "w_gate_up",
                                               "w_down"))
    live = int((qslot - vfrom).sum()) * L * hkv * hd * 2
    log(f"K4 fused_decode_step 7B widths L={L} B={B} S={S}: x_out row-wise "
        f"rel err {rel:.4g} (2e-2), max abs {err:.4g}; {'; '.join(codes)}; "
        f"cache outside the slot unchanged; two launches bit-equal; kernel "
        f"{ms:.4f} ms "
        f"({(wbytes + live) / ms / 1e6:.0f} GB/s of weights + live KV), "
        f"plain {pms:.4f} ms")
    return entry(err, ms, pms, *fused_bound(
        blocks, x, L, hkv, hd, cfg.num_heads, int((qslot - vfrom).sum()), B))


def check_flash(dev, flush):
    """K5 at B = 64, Hq = 32, Hkv = 8, d = 128: square Sq = Sk = 512 and the
    rectangular Sq = 128, q_offset = 512, Sk = 640, ragged valid_from.
    Returns the square case's entry (max_abs_err on live rows), with the
    time of scaled_dot_product_attention(attn_mask=K5's mask,
    enable_gqa=True) as its library call."""
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
        got = kfa.flash_attention(*args, **kw).float()
        want = kfa.flash_attention_plain(*args, **kw).float()
        torch.cuda.synchronize()
        qpos = qoff + torch.arange(sq, device=dev)
        live = qpos[None, :] >= vfrom[:, None]         # (B, Sq)
        err = float((got - want).abs().transpose(1, 2)[live].max())
        if not bool(torch.isfinite(got).all()) or err > 2e-2:
            raise AssertionError(f"K5 Sq={sq} Sk={sk}: max abs err on live "
                                 f"rows {err:.4g} > 2e-2")
        if not torch.equal(kfa.flash_attention(*args, **kw).float(), got):
            raise AssertionError(f"K5 Sq={sq} Sk={sk}: two launches differ")
        ms = time_ms(lambda: kfa.flash_attention(*args, **kw), flush)
        pms = time_ms(lambda: kfa.flash_attention_plain(*args, **kw), flush,
                      reps=5, warmup=1)
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
    return first


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
    with 1, block boundaries and the whole table. Returns their entries,
    from the per-op geometry that the engine's per-op routes run."""
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
        f"live KV), plain {pms:.4f} ms")
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
    # (allow_tf32 off) rtol 1e-4 plus 1e-4 of the max
    for size, dtype, rtol, atol in ((4096, torch.bfloat16, 1e-2, 1e-3),
                                    (2048, torch.float32, 1e-4, 1e-4)):
        a = torch.randn((size, size), generator=g, device=dev).to(dtype)
        b = torch.randn((size, size), generator=g, device=dev).to(dtype)
        got = kt.tiled_matmul(a, b).float()
        want = kt.tiled_matmul_plain(a, b).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        bound = rtol * want.abs() + atol * float(want.abs().max())
        if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
            raise AssertionError(f"K9 {size}^3 {dtype}: max err "
                                 f"{float(err.max()):.4g} exceeds rtol {rtol}")
        ms = time_ms(lambda: kt.tiled_matmul(a, b), flush)
        pms = time_ms(lambda: kt.tiled_matmul_plain(a, b), flush)
        lib = time_ms(lambda: torch.matmul(a, b), flush)
        flop = 2 * size ** 3
        log(f"K9 tiled_matmul {size}^3 {str(dtype)[6:]}: max_abs_err "
            f"{float(err.max()):.4g} (rtol {rtol} + {atol} of the max), "
            f"kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s), plain "
            f"{pms:.4f} ms, torch.matmul {lib:.4f} ms "
            f"({flop / lib / 1e9:.1f} TFLOP/s)")
        if "tiled_matmul" not in out:
            out["tiled_matmul"] = entry(
                float(err.max()), ms, pms, 3 * nbytes(a), flop,
                "bf16" if dtype == torch.bfloat16 else "fp32", lib)
        del a, b, got, want, err, bound

    # K10/K11 at 256 MiB (K11 also at 2 GiB), f32 (N, 128): bit-equal
    for mib in (256, 2048):
        x = torch.randn((mib * (1 << 20) // 512, 128), generator=g,
                        device=dev)
        cases = [("strided_copy", "K11", kb._strided_copy,
                  kb._strided_copy_plain,
                  lambda: x.view(-1, 32, 8, 128)[:, 0].contiguous().view(-1, 128),
                  32)]
        if mib == 256:
            cases.insert(0, ("stream_copy", "K10", kb._stream_copy,
                             kb._stream_copy_plain, x.clone, 1))
        for name, tag, fn, plain, library, stride in cases:
            got = fn(x)
            if not torch.equal(got, plain(x)) or not torch.equal(got,
                                                                 library()):
                raise AssertionError(f"{tag} at {mib} MiB: not bit-equal")
            ms = time_ms(lambda: fn(x), flush)
            pms = time_ms(lambda: plain(x), flush)
            lib = time_ms(library, flush)
            moved = 2 * nbytes(got)
            log(f"{tag} {name} {mib} MiB stride {stride}: bit-equal to plain "
                f"and library, kernel {ms:.4f} ms ({moved / ms / 1e6:.0f} "
                f"GB/s read + write), plain {pms:.4f} ms, library "
                f"{lib:.4f} ms ({moved / lib / 1e6:.0f} GB/s)")
            if mib == 256:
                out[name] = entry(0.0, ms, pms, moved, 0, library_ms=lib)
            del got
        del x
        torch.cuda.empty_cache()

    # K12 at (524288, 128) f32 and bf16: bit-equal to a + b and torch.add
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
            f"a + b and torch.add, kernel {ms:.4f} ms ({moved / ms / 1e6:.0f}"
            f" GB/s), plain {pms:.4f} ms, torch.add {lib:.4f} ms")
        if "vector_add" not in out:
            out["vector_add"] = entry(0.0, ms, pms, moved, a.numel(), "fp32",
                                      lib)
        del a, b, got
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


def slice_parity(dev, fused: bool):
    """Phase 4: kernels vs plain entry points on a 2-layer 7B-width model,
    on the fused (default) or the per-op decode path."""
    import torch

    from physics_llm_inference_tpu_torch.models import transformer as tf
    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import init_params_int8

    km = kernel_module("int8_matmul")
    cfg = ModelConfig(num_layers=2, fused_decode=fused, **WIDTHS)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    params = init_params_int8(g, cfg)
    lens = torch.randint(64, PROMPT + 1, (BATCH,), generator=g, device=dev)
    prompts = [torch.randint(1, cfg.vocab_size, (int(n),), generator=g,
                             device=dev).tolist() for n in lens]
    steps = [torch.randint(1, cfg.vocab_size, (BATCH,), generator=g,
                           device=dev) for _ in range(8)]

    path = (("int8_matmul", "fused_decode_step", "lmhead_greedy") if fused
            else ("int8_matmul", "int8_kv_decode_attention", "lmhead_greedy"))
    before = read_launches()
    logits_k, seen_k = run_slice(params, cfg, prompts, steps, dev)
    after = read_launches()
    used = {n: after[n] - before[n] for n in path}
    if min(used.values()) == 0:
        raise AssertionError(f"slice parity: kernels not all used {used}")
    # the transformer's references to every kernel entry point, swapped for
    # the plain versions
    names = [n for n in KERNELS if hasattr(tf, n)]
    saved = {n: getattr(tf, n) for n in names}
    for n in names:
        setattr(tf, n, getattr(kernel_module(n), f"{n}_plain"))
    try:
        logits_p, seen_p = run_slice(params, cfg, prompts, steps, dev)
    finally:
        for n, fn in saved.items():
            setattr(tf, n, fn)

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
    ties = 0
    for i, ((xk, tk), (xp, tp)) in enumerate(zip(seen_k, seen_p)):
        worst = max(worst, rel_check(xk, xp, f"step {i} hidden"))
        # the kernel's token must be a bf16 max of the plain run's logits
        xn = tf.rms_norm(xp.bfloat16(), params["norm"], cfg.norm_eps)
        lg = km.int8_matmul_plain(xn, params["lm_head"].q, params["lm_head"].s,
                                  out_dtype=torch.float32).bfloat16().float()
        top = lg.max(dim=-1).values
        gap = top - lg.gather(1, tk.long()[:, None])[:, 0]
        if bool((gap > bf16_ulp(top)).any()):
            raise AssertionError(f"slice parity step {i}: token off the max")
        ties += int((tk != tp).sum())
    log(f"slice parity, {'fused' if fused else 'per-op'} decode (7B "
        f"widths, 2 layers, B={BATCH}, 8 decode steps): max row-wise "
        f"relative error {worst:.4g} (rtol 2e-2), tokens equal except "
        f"{ties} bf16 near-ties, kernel launches {used}")


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


def full_run(dev, params, prompt: int, fused: bool, layers: int,
             expect) -> dict:
    """Phase 5: one path of the main path at full width, `layers` deep.
    Returns the launch counts of its timed run."""
    import torch

    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.runtime.generate import \
        cached_generate
    from physics_llm_inference_tpu_torch.runtime.kv_cache import \
        calculate_kv_cache_size
    from physics_llm_inference_tpu_torch.specs.gpu import (decode_step_floor_s,
                                                           get_gpu_spec)

    cfg = ModelConfig(num_layers=layers, fused_decode=fused, **WIDTHS)
    g = torch.Generator().manual_seed(SEED + prompt)
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, prompt),
                            generator=g).tolist()

    def run():
        return cached_generate(params, cfg, prompts, NEW_TOKENS,
                               temperature=0.0, kv_dtype=torch.int8)

    t0 = time.perf_counter()
    run()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = run()
    counts = read_launches()
    what = (f"{layers}-layer 7B, prompt {prompt}, "
            f"{'fused' if fused else 'per-op'} decode")
    log(f"{what}: warm-up run {warm:.1f} s; launches during the timed run: "
        f"{counts}")
    missing = [n for n in expect if counts[n] == 0]
    if missing or (fused and counts["fused_decode_step"] != NEW_TOKENS):
        raise AssertionError(f"{what}: kernels of the path not launched "
                             f"as expected: {counts}")
    toks = out.tokens
    if toks.shape != (BATCH, NEW_TOKENS) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens: shape {toks.shape}, range "
                             f"[{toks.min()}, {toks.max()}]")

    spec = get_gpu_spec()
    kv = calculate_kv_cache_size(BATCH, prompt + NEW_TOKENS, cfg.num_layers,
                                 cfg.num_kv_heads, cfg.head_dim, 1)
    floor_s = decode_step_floor_s(cfg.param_count(), kv["total_bytes"], spec)
    tok_s = out.decode_tokens_per_s
    share = tok_s / (BATCH / floor_s)
    log(f"{what} (B={BATCH}, {NEW_TOKENS} greedy tokens, INT8 W+KV): "
        f"prefill (TTFT) {out.prefill_s * 1e3:.1f} ms, decode "
        f"{out.decode_s * 1e3:.1f} ms, {tok_s:.1f} tok/s, "
        f"{out.time_per_output_token_s * 1e3:.2f} ms/step; HBM floor "
        f"{floor_s * 1e6:.0f} us/step on {spec.name} spec "
        f"({spec.hbm_gbps:.0f} GB/s) -> share {share:.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return counts


def full_runs(dev) -> dict:
    """Phase 5: the default config at prompt 128 and 512, then the per-op
    decode path. Returns each kernel's launches summed over the timed runs."""
    import torch

    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import init_params_int8

    cfg = ModelConfig(num_layers=32, **WIDTHS)
    t0 = time.perf_counter()
    params = init_params_int8(torch.Generator(device=dev).manual_seed(SEED),
                              cfg)
    torch.cuda.synchronize()
    log(f"7B init on the card: {cfg.param_count() / 1e9:.2f}B params, "
        f"{time.perf_counter() - t0:.1f} s")
    fused = ("int8_matmul", "fused_decode_step", "lmhead_greedy")
    runs = [full_run(dev, params, PROMPT, True, 32, fused),
            full_run(dev, params, LONG_PROMPT, True, 32,
                     fused + ("flash_attention",)),
            full_run(dev, params, PROMPT, False, 32,
                     ("int8_matmul", "int8_kv_decode_attention",
                      "lmhead_greedy"))]
    return {n: sum(r[n] for r in runs) for n in KERNELS}, params


def serve(dev, params, cfg, what: str, kw: dict, n: int, prompt: int,
          tokens: int, expect, forbid, shared: bool = False,
          warm: int = 0) -> dict:
    """Phase 5, paged: one PagedInferenceEngine serving n greedy requests,
    all submitted at once and run to the end, after a warm wave of `warm`
    requests (16 tokens each, not measured). With `shared`, every fourth
    prompt starts with one of SHARED_PREFIXES block-sized prefixes, as in
    scripts/bench_serving7b.py. Returns the launch counts of the measured
    wave."""
    import gc

    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.serve.engine import GenerationRequest
    from physics_llm_inference_tpu_torch.serve.paged_engine import (
        PagedEngineConfig, PagedInferenceEngine)

    pc = PagedEngineConfig(**kw)
    eng = PagedInferenceEngine(params, cfg, pc)
    rng = np.random.default_rng(SEED)
    prefixes = [rng.integers(1, cfg.vocab_size, pc.block_size).tolist()
                for _ in range(SHARED_PREFIXES)]

    def wave(count, max_tokens):
        rids = []
        for i in range(count):
            pre = (prefixes[(i // 4) % SHARED_PREFIXES]
                   if shared and i % 4 == 0 else [])
            p = pre + rng.integers(1, cfg.vocab_size,
                                   prompt - len(pre)).tolist()
            rids.append(eng.submit_request(GenerationRequest(
                prompt_tokens=p, max_tokens=max_tokens, temperature=0.0)))
        eng.run_until_done(rids)
        torch.cuda.synchronize()
        return rids

    t0 = time.perf_counter()
    if warm:
        wave(warm, 16)
    warm_s = time.perf_counter() - t0
    hits0 = eng.stats()["radix_hit_tokens"]
    pre0 = eng.scheduler.num_preempted
    # host time of the prefill and decode dispatches, each ended by a
    # synchronize (both already wait for the device: the tokens come back)
    spent = {"prefill": 0.0, "decode": 0.0}

    def timed(kind, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[kind] += time.perf_counter() - t
            return out
        return run

    eng._prefill = timed("prefill", eng._prefill)
    eng._decode = timed("decode", eng._decode)
    torch.cuda.reset_peak_memory_stats()
    eng.dispatch_trace = []
    reset_launches()
    t0 = time.perf_counter()
    rids = wave(n, tokens)
    wall = time.perf_counter() - t0
    counts = read_launches()
    res = [eng.get_result(r) for r in rids]
    bad = [r.request_id for r in res if len(r.tokens) != tokens
           or min(r.tokens) < 0 or max(r.tokens) >= cfg.vocab_size]
    if bad:
        raise AssertionError(f"{what}: requests with wrong tokens: {bad[:5]}")
    steps = sum(t[1] for t in eng.dispatch_trace if t[0] == "decode")
    missing = [k for k in expect if counts[k] == 0]
    wrong = [k for k in forbid if counts[k] != 0]
    if missing or wrong or ("fused_paged_decode_step" in expect
                            and counts["fused_paged_decode_step"] != steps):
        raise AssertionError(f"{what}: kernels not launched as expected "
                             f"({steps} decode steps): {counts}")
    ttft = sorted(r.ttft_s for r in res)
    hits = eng.stats()["radix_hit_tokens"] - hits0
    preempt = eng.scheduler.num_preempted - pre0
    if shared and hits <= 0:
        raise AssertionError(f"{what}: no radix hit")
    prefills = sum(1 for t in eng.dispatch_trace if t[0] == "prefill")
    log(f"{what}: {n} requests x prompt {prompt} -> {tokens} greedy tokens"
        f"{', every 4th behind a shared prefix' if shared else ''}; warm "
        f"wave {warm} requests {warm_s:.1f} s; measured wall {wall:.3f} s, "
        f"{n * tokens / wall:.1f} output tok/s, {n / wall:.2f} requests/s, "
        f"TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms p90 "
        f"{ttft[int(len(ttft) * 0.9)] * 1e3:.1f} ms; radix cache "
        f"{type(eng.radix).__name__ if eng.radix else 'off'}, "
        f"radix_hit_tokens {hits}, preemptions {preempt}; {prefills} "
        f"prefill and "
        f"{len(eng.dispatch_trace) - prefills} decode dispatches, {steps} "
        f"decode steps; prefill dispatches {spent['prefill']:.3f} s, decode "
        f"dispatches {spent['decode']:.3f} s, the rest (scheduling, prefill "
        f"sampling) {wall - sum(spent.values()):.3f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def serving_runs(dev, params) -> dict:
    """Phase 5, paged: the bench_serving7b configuration (K8 decode, K5
    prefill), then the per-op routes at full width with fewer requests:
    INT8 pools at block size 16 (K6) and bf16 pools (K7). Returns each
    kernel's launches summed over the measured waves."""
    from physics_llm_inference_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(num_layers=32, **dict(WIDTHS, max_seq_len=1024))
    small = dict(max_batch=64, block_size=16, max_blocks_per_request=64,
                 num_blocks=64 * 64 + 16, decode_horizon=8,
                 prefill_tokens_per_iter=2048)
    runs = [
        serve(dev, params, cfg, "paged engine, bench_serving7b configuration",
              dict(max_batch=64, kv_dtype="int8", decode_horizon=8,
                   enable_radix=True, prefill_tokens_per_iter=2048),
              SERVE_REQUESTS, SERVE_PROMPT, SERVE_TOKENS,
              expect=("fused_paged_decode_step", "flash_attention",
                      "int8_matmul"),
              forbid=("int8_paged_decode_attention",
                      "paged_decode_attention"), shared=True, warm=64),
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


def main() -> int:
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
    _build.build(verbose=True)
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.LIB_PATH}")

    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    kernels = check_kernels(dev, flush)
    del flush
    torch.cuda.empty_cache()
    slice_parity(dev, fused=False)
    slice_parity(dev, fused=True)
    paged_slice_parity(dev)
    torch.cuda.empty_cache()
    dense, params = full_runs(dev)
    paged = serving_runs(dev, params)
    del params
    torch.cuda.empty_cache()
    micro = micro_path(dev)
    counts = {k: dense[k] + paged[k] + micro[k] for k in KERNELS}

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
    sys.exit(main())
