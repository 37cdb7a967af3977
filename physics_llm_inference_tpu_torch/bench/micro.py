"""Microbenchmarks with roofline attribution (counterpart:
physics_llm_inference_tpu/bench/micro.py:20-142).

GEMM (prefill proxy), GEMV and batched GEMV (decode proxy), attention and
precision, each attributed against the card's roofline (specs/roofline.py).
Inputs come from a `torch.Generator` on the device; every function takes a
`device`, the card by default. Where the JAX package runs a Pallas kernel,
this runs the port's kernel: `bench_gemm(use_kernel=True)` K9
`tiled_matmul`, `bench_gemv(int8_weights=True)` K1 `int8_matmul`,
`bench_attention(use_flash=True)` K5 `flash_attention`. Where it calls XLA
(`jnp.dot`, the grouped SDPA), this calls `torch.matmul` and the port's
`grouped_sdpa`. Times are `utils.timing.benchmark_fn`'s: CUDA events after
an L2-flushing write on the card. On a CPU device the roofline reads the
H100 SXM's constants, as the JAX package reads v5e's off the TPU; a CPU
time is no device number.
"""
from __future__ import annotations

import torch

from ..specs.gpu import H100_SXM, get_gpu_spec
from ..specs.roofline import roofline_throughput
from ..utils.timing import benchmark_fn


def _dtype_name(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"


def _roofline_frac(flops: float, bytes_moved: float, seconds: float,
                   dtype: str, device="cuda") -> dict:
    spec = (get_gpu_spec() if torch.device(device).type == "cuda"
            else H100_SXM)
    ai = flops / bytes_moved
    attainable = roofline_throughput(ai, spec, dtype)
    achieved = flops / seconds
    return {
        "achieved_tflops": achieved / 1e12,
        "attainable_tflops": attainable / 1e12,
        "roofline_fraction": achieved / attainable,
        "arithmetic_intensity": ai,
        "gb_per_s": bytes_moved / seconds / 1e9,
    }


def bench_gemm(m: int = 4096, n: int = 4096, k: int = 4096,
               dtype=torch.bfloat16, iters: int = 10,
               use_kernel: bool = False, device="cuda") -> dict:
    """Prefill-shaped GEMM: K9 `tiled_matmul` with `use_kernel`, else
    `torch.matmul`."""
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((m, k), generator=g, device=device, dtype=dtype)
    b = torch.randn((k, n), generator=g, device=device, dtype=dtype)
    if use_kernel:
        from ..kernels.matmul import tiled_matmul
        fn = tiled_matmul
    else:
        fn = torch.matmul
    r = benchmark_fn(fn, a, b, iters=iters, name=f"gemm {m}x{n}x{k}")
    moved = a.element_size() * (m * k + k * n + m * n)
    out = {"mean_ms": r.mean_ms, "shape": (m, n, k)}
    out.update(_roofline_frac(2.0 * m * n * k, moved, r.mean_ms / 1e3,
                              _dtype_name(dtype), device))
    return out


def bench_gemv(batch: int = 1, n: int = 4096, k: int = 4096,
               dtype=torch.bfloat16, iters: int = 20,
               int8_weights: bool = False, device="cuda") -> dict:
    """Decode-shaped (batched) GEMV. With int8_weights=True it runs K1
    `int8_matmul` over per-output-channel int8 weights: weight bytes halve,
    so the memory-bound ceiling doubles."""
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((batch, k), generator=g, device=device, dtype=dtype)
    w = torch.randn((k, n), generator=g, device=device, dtype=torch.float32)
    if int8_weights:
        from ..kernels.int8_matmul import int8_matmul, quantize_weights_int8

        wq, s = quantize_weights_int8(w)

        def fn(x):
            return int8_matmul(x, wq, s)

        weight_bytes = wq.numel() * wq.element_size() \
            + s.numel() * s.element_size()
    else:
        wd = w.to(dtype)

        def fn(x):
            return x @ wd

        weight_bytes = wd.numel() * wd.element_size()
    r = benchmark_fn(fn, x, iters=iters, name=f"gemv b{batch} {k}x{n}")
    moved = weight_bytes + x.element_size() * (batch * k + batch * n)
    out = {"mean_ms": r.mean_ms, "batch": batch, "int8": int8_weights}
    out.update(_roofline_frac(2.0 * batch * n * k, moved, r.mean_ms / 1e3,
                              _dtype_name(dtype), device))
    return out


def bench_attention(batch: int = 4, heads: int = 16, kv_heads: int = 4,
                    seq: int = 2048, head_dim: int = 128,
                    dtype=torch.bfloat16, iters: int = 10,
                    use_flash: bool = True, causal: bool = True,
                    device="cuda") -> dict:
    """Flash (K5 `flash_attention`) vs naive attention (the port's
    `grouped_sdpa` with the causal mask)."""
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((batch, heads, seq, head_dim), generator=g, device=device,
                    dtype=dtype)
    k = torch.randn((batch, kv_heads, seq, head_dim), generator=g,
                    device=device, dtype=dtype)
    v = torch.randn((batch, kv_heads, seq, head_dim), generator=g,
                    device=device, dtype=dtype)
    if use_flash:
        from ..kernels.flash_attention import flash_attention

        def fn(q, k, v):
            return flash_attention(q, k, v, causal=causal)
    else:
        from ..ops.gqa import grouped_sdpa

        mask = None
        if causal:
            idx = torch.arange(seq, device=device)
            mask = (idx[None, :] <= idx[:, None])[None, None, None]

        def fn(q, k, v):
            return grouped_sdpa(q, k, v, mask=mask)
    r = benchmark_fn(fn, q, k, v, iters=iters,
                     name=f"attn s{seq} {'flash' if use_flash else 'naive'}")
    flops = 4.0 * batch * heads * seq * seq * head_dim * (0.5 if causal
                                                          else 1.0)
    moved = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    out = {"mean_ms": r.mean_ms, "flash": use_flash, "seq": seq}
    out.update(_roofline_frac(flops, moved, r.mean_ms / 1e3,
                              _dtype_name(dtype), device))
    return out


def roofline_report(results: list[dict]) -> str:
    lines = ["kernel roofline report:"]
    for r in results:
        lines.append(
            f"  {r.get('shape', r.get('seq', r.get('batch')))}: "
            f"{r['achieved_tflops']:.1f}/{r['attainable_tflops']:.1f} TF "
            f"({100*r['roofline_fraction']:.0f}% of roofline, "
            f"AI {r['arithmetic_intensity']:.1f})")
    return "\n".join(lines)


def bench_precision(size: int = 4096, iters: int = 10,
                    device="cuda") -> dict:
    """bf16 (tensor-core fast path) vs full-f32 `torch.matmul` throughput.
    The f32 products run with `allow_tf32` False, the JAX package's
    `Precision.HIGHEST`; the flag is restored afterwards."""
    g = torch.Generator(device=device).manual_seed(0)
    a32 = torch.randn((size, size), generator=g, device=device)
    b32 = torch.randn((size, size), generator=g, device=device)
    a16, b16 = a32.bfloat16(), b32.bfloat16()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        r32 = benchmark_fn(torch.matmul, a32, b32, iters=iters, name="fp32")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    r16 = benchmark_fn(torch.matmul, a16, b16, iters=iters, name="bf16")
    speedup = r32.mean_ms / r16.mean_ms
    return {
        "fp32_ms": r32.mean_ms,
        "bf16_ms": r16.mean_ms,
        "speedup": speedup,
        "mxu_fast_path_detected": speedup > 1.5,
    }
