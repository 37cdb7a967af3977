"""Comparison benchmark suite (counterpart:
physics_llm_inference_tpu/bench/suite.py:34-128): MHA vs GQA, fused vs
unfused SwiGLU, naive O(n^2) vs cached O(n) generation, the GEMM/GEMV
roofline, flash vs naive attention and static batching waste. One command,
JSON out with the JAX suite's keys; it runs on the card.

Run: python -m physics_llm_inference_tpu_torch.bench.suite [--quick]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import init_params
from ..ops.ffn import fused_swiglu, swiglu
from ..ops.gqa import gqa_attention, kv_cache_bytes_per_token
from ..runtime.generate import _sync, cached_generate, naive_generate
from ..sched.static_batcher import analyze_static_batching_waste
from ..utils.timing import benchmark_fn
from .micro import bench_attention, bench_gemm, bench_gemv


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _randn(g, shape, device, scale=1.0):
    return (torch.randn(shape, generator=g, device=device)
            * scale).bfloat16()


def mha_vs_gqa(dim=1024, heads=8, seq=512, iters=10, device="cuda"):
    """MHA vs GQA block latency + KV accounting."""
    x = _randn(torch.Generator(device=device).manual_seed(0), (4, seq, dim),
               device)
    hd = dim // heads
    out = {}
    for name, hkv in [("mha", heads), ("gqa4x", heads // 4)]:
        g = torch.Generator(device=device).manual_seed(1)
        wq = _randn(g, (dim, dim), device, 0.05)
        wk = _randn(g, (dim, hkv * hd), device, 0.05)
        wv = _randn(g, (dim, hkv * hd), device, 0.05)
        wo = _randn(g, (dim, dim), device, 0.05)
        r = benchmark_fn(gqa_attention, x, wq, wk, wv, wo, heads, hkv,
                         iters=iters, name=name)
        out[name] = {"mean_ms": r.mean_ms,
                     "kv_bytes_per_token": kv_cache_bytes_per_token(hkv, hd)}
    out["kv_reduction"] = (out["mha"]["kv_bytes_per_token"]
                           / out["gqa4x"]["kv_bytes_per_token"])
    return out


def fused_vs_unfused(dim=1024, ff=2816, seq=512, iters=10, device="cuda"):
    """Fused vs unfused SwiGLU."""
    x = _randn(torch.Generator(device=device).manual_seed(0), (4, seq, dim),
               device)
    g = torch.Generator(device=device).manual_seed(1)
    wg = _randn(g, (dim, ff), device, 0.05)
    wu = _randn(g, (dim, ff), device, 0.05)
    wd = _randn(g, (ff, dim), device, 0.05)
    wgu = torch.cat([wg, wu], dim=1)
    r_u = benchmark_fn(swiglu, x, wg, wu, wd, iters=iters, name="unfused")
    r_f = benchmark_fn(fused_swiglu, x, wgu, wd, iters=iters, name="fused")
    return {"unfused_ms": r_u.mean_ms, "fused_ms": r_f.mean_ms,
            "speedup": r_u.mean_ms / r_f.mean_ms}


def naive_vs_cached(prompt_len=64, new_tokens=64, device="cuda"):
    """O(n^2) vs O(n) generation on a small bf16 model: wall times, each
    ended by a synchronize."""
    cfg = ModelConfig(vocab_size=1000, hidden_dim=256, num_layers=4,
                      num_heads=4, num_kv_heads=2, intermediate_dim=512,
                      max_seq_len=512, dtype="bfloat16")
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    dev = params["embed"].device
    ids = torch.ones((1, prompt_len), dtype=torch.int64, device=dev)

    naive_generate(params, cfg, ids, 4)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    naive_generate(params, cfg, ids, new_tokens)
    _sync(dev)
    t_naive = time.perf_counter() - t0
    prompt = [1] * prompt_len
    cached_generate(params, cfg, [prompt], 4)  # warm-up
    out = cached_generate(params, cfg, [prompt], new_tokens)
    t_cached = out.prefill_s + out.decode_s
    return {"naive_s": t_naive, "cached_s": t_cached,
            "speedup": t_naive / t_cached if t_cached else 0.0}


def static_batching_waste():
    """Padding waste of pad-to-max batches on a skewed length distribution."""
    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.lognormal(4.5, 0.8, 256).clip(8, 2048)]
    return analyze_static_batching_waste(lens, batch_size=8)


def main(argv=None) -> dict:
    """Run the suite on the card, print its JSON and return it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the suite runs on a CUDA device; torch sees none")
    iters = 3 if args.quick else 10

    results = {}
    log("[suite] mha vs gqa ...")
    results["mha_vs_gqa"] = mha_vs_gqa(iters=iters)
    log("[suite] fused vs unfused swiglu ...")
    results["swiglu_fusion"] = fused_vs_unfused(iters=iters)
    log("[suite] naive vs cached generation ...")
    results["naive_vs_cached"] = naive_vs_cached(
        prompt_len=32 if args.quick else 64,
        new_tokens=16 if args.quick else 64)
    log("[suite] gemm/gemv roofline ...")
    size = 1024 if args.quick else 4096
    results["gemm"] = bench_gemm(size, size, size, iters=iters)
    results["gemv_bf16"] = bench_gemv(8, size, size, iters=iters)
    results["gemv_int8"] = bench_gemv(8, size, size, iters=iters,
                                      int8_weights=True)
    log("[suite] flash vs naive attention ...")
    seq = 512 if args.quick else 2048
    results["attn_flash"] = bench_attention(seq=seq, iters=iters,
                                            use_flash=True)
    results["attn_naive"] = bench_attention(seq=seq, iters=iters,
                                            use_flash=False)
    log("[suite] static batching waste ...")
    results["static_batching"] = static_batching_waste()

    print(json.dumps(results, indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
