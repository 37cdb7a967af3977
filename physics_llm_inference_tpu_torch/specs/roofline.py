"""Roofline model (counterpart: physics_llm_inference_tpu/specs/roofline.py:17-98).

The same formulas, parameterized by a `GPUSpec` (specs/gpu.py): arithmetic
intensity of GEMM/GEMV/batched GEMV, the ridge point, attainable
throughput, the batch at which batched decode goes compute-bound, and the
memory-bound floor of one decode step (`decode_step_floor_s` in
specs/gpu.py is that floor in bytes; this module's form counts the weight
bytes from a parameter count).
"""
from __future__ import annotations

from .gpu import GPUSpec, decode_step_floor_s

_BYTES = {"fp32": 4, "f32": 4, "bf16": 2, "fp16": 2, "int8": 1, "fp8": 1}


def dtype_bytes(dtype: str) -> int:
    return _BYTES[dtype]


def arithmetic_intensity_gemm(m: int, n: int, k: int,
                              dtype: str = "bf16") -> float:
    """FLOP/byte of an (m,k)@(k,n) GEMM: 2mnk over inputs + output at
    `dtype` width."""
    b = dtype_bytes(dtype)
    return 2.0 * m * n * k / (b * (m * k + k * n + m * n))


def arithmetic_intensity_gemv(n: int, k: int, dtype: str = "bf16") -> float:
    """FLOP/byte of a (k,)@(k,n) GEMV (decode-shaped, weight-bound)."""
    return arithmetic_intensity_gemm(1, n, k, dtype)


def arithmetic_intensity_batched_gemv(batch: int, n: int, k: int,
                                      dtype: str = "bf16") -> float:
    """FLOP/byte of a batched decode matmul (batch, k) @ (k, n): the weight
    is read once and amortized over the batch."""
    return arithmetic_intensity_gemm(batch, n, k, dtype)


def ridge_point(spec: GPUSpec, dtype: str = "bf16") -> float:
    """FLOP/byte where the card goes memory- -> compute-bound."""
    return spec.ridge_point(dtype)


def roofline_throughput(ai: float, spec: GPUSpec, dtype: str = "bf16") -> float:
    """Attainable FLOP/s = min(AI * bandwidth, peak)."""
    peak = {"bf16": spec.peak_flops, "int8": spec.peak_int8_ops,
            "fp32": spec.fp32_tflops * 1e12}[dtype]
    return min(ai * spec.hbm_bandwidth, peak)


def is_compute_bound(ai: float, spec: GPUSpec, dtype: str = "bf16") -> bool:
    return ai >= ridge_point(spec, dtype)


def find_transition_batch_size(n: int, k: int, spec: GPUSpec,
                               dtype: str = "bf16",
                               max_batch: int = 8192) -> int | None:
    """Smallest power-of-2 batch at which batched decode GEMV goes
    compute-bound; None if no batch <= max_batch crosses the ridge."""
    batch = 1
    while batch <= max_batch:
        if is_compute_bound(
                arithmetic_intensity_batched_gemv(batch, n, k, dtype), spec,
                dtype):
            return batch
        batch *= 2
    return None


def decode_step_time_lower_bound(num_params: int, kv_bytes: int, batch: int,
                                 spec: GPUSpec,
                                 weight_dtype: str = "int8") -> float:
    """Memory-bound lower bound (seconds) of one decode step: every weight
    byte and every live KV byte crosses device memory once. `batch` is kept
    for the reference's signature; the bound does not depend on it."""
    return decode_step_floor_s(num_params * dtype_bytes(weight_dtype),
                               kv_bytes, spec)
