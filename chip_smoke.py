#!/usr/bin/env python3
"""Smoke run of the PyTorch port (physics_llm_inference_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no final line):
1. device: the card's name and power limit (nvidia-smi); no CUDA -> fail;
2. build: nvcc compiles csrc/*.cu into build/, one process per source, all
   in parallel (kernels/_build.py);
3. each CUDA kernel (K1 int8_matmul, K2 int8_kv_decode_attention, K3
   lmhead_greedy, K4 fused_decode_step, K5 flash_attention) against its
   plain torch version at the main path's shapes, with the tolerance
   stated, and both timed with CUDA events;
4. slice parity: a model at the 7B widths with 2 layers runs prefill plus 8
   teacher-forced decode steps with the kernels and again with the kernels'
   entry points swapped for their plain versions (here, not in the package),
   once on the per-op decode path and once on the fused one; final hidden
   states and greedy tokens are compared;
5. the main path at full size: the 7B-class config of bench.py (32 layers,
   the default ModelConfig: fused_decode=True, attention_impl="auto")
   initialized on the card from a seed, cached_generate at batch 64 with 128
   greedy tokens over an INT8 KV cache, at prompt 128 (fused decode) and
   prompt 512 (flash prefill, fused decode); then the per-op decode path
   (fused_decode=False) at prompt 128, which runs K2. Every kernel of each
   path must have launched during that path's timed run.
Then one JSON line with each kernel's numbers, and the last line
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
KERNELS = {  # name: (module, CUDA source, the TPU kernel it replaces)
    "int8_matmul": ("int8_matmul", "csrc/int8_matmul.cu",
                    "physics_llm_inference_tpu/kernels/int8_matmul.py:52"),
    "int8_kv_decode_attention": (
        "int8_kv_attention", "csrc/int8_kv_attention.cu",
        "physics_llm_inference_tpu/kernels/int8_kv_attention.py:148"),
    "lmhead_greedy": ("lmhead", "csrc/lmhead.cu",
                      "physics_llm_inference_tpu/kernels/lmhead.py:92"),
    "fused_decode_step": (
        "fused_decode", "csrc/fused_decode.cu",
        "physics_llm_inference_tpu/kernels/fused_decode.py:1200"),
    "flash_attention": (
        "flash_attention", "csrc/flash_attention.cu",
        "physics_llm_inference_tpu/kernels/flash_attention.py:310"),
}


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
        kernel_module(name).launches = 0


def read_launches() -> dict:
    return {name: kernel_module(name).launches for name in KERNELS}


def row_rel(a, b) -> float:
    """Row-wise relative error ||a - b|| / ||b||, the worst row."""
    return float(((a - b).norm(dim=-1)
                  / b.norm(dim=-1).clamp_min(1e-30)).max())


def check_kernels(dev, flush) -> dict:
    """Phase 3. Returns {kernel: (max_abs_err, ms, plain_ms)}."""
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
    k1_err, k1_ms, k1_plain = 0.0, 0.0, 0.0
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
    log(f"K1 one decode layer (wqkv+wo+gate_up+down): kernel {k1_ms:.4f} ms, "
        f"plain {k1_plain:.4f} ms")
    out["int8_matmul"] = (k1_err, k1_ms, k1_plain)

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
    out["int8_kv_decode_attention"] = (err, ms, pms)

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
    out["lmhead_greedy"] = (err, ms, pms)
    out["fused_decode_step"] = check_fused(dev, flush)
    out["flash_attention"] = check_flash(dev, flush)
    return out


def check_fused(dev, flush):
    """K4 at the 7B widths, 2 layers, B = 64, S = 256, ragged valid_from,
    the generate path's in-place write at slot == q_slot. Returns
    (max_abs_err of x_out, ms, plain_ms)."""
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
    return err, ms, pms


def check_flash(dev, flush):
    """K5 at B = 64, Hq = 32, Hkv = 8, d = 128: square Sq = Sk = 512 and the
    rectangular Sq = 128, q_offset = 512, Sk = 640, ragged valid_from.
    Returns (max_abs_err on live rows, ms, plain_ms) of the square case."""
    import torch

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
        log(f"K5 flash_attention B={B} Hq={hq} Hkv={hkv} d={d} Sq={sq} "
            f"Sk={sk} q_offset={qoff}, ragged valid_from: max abs err on "
            f"live rows {err:.4g} (atol 2e-2), two launches bit-equal, "
            f"kernel {ms:.4f} ms "
            f"({flop / ms / 1e9:.1f} TFLOP/s of live causal work), plain "
            f"{pms:.4f} ms")
        first = first or (err, ms, pms)
    return first


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
    used = {n: kernel_module(n).launches - before[n] for n in path}
    if min(used.values()) == 0:
        raise AssertionError(f"slice parity: kernels not all used {used}")
    # the transformer's references to every kernel entry point, swapped for
    # the plain versions
    saved = {n: getattr(tf, n) for n in KERNELS}
    for n in KERNELS:
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
    return {n: sum(r[n] for r in runs) for n in KERNELS}


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
    torch.cuda.empty_cache()
    counts = full_runs(dev)

    rows = []
    for name, (err, ms, pms) in kernels.items():
        _, src, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": f"{PKG}/{src}",
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": pms})
    log(nvidia_smi())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
