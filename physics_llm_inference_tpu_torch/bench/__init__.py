"""Benchmarks (counterpart: physics_llm_inference_tpu/bench). The serving
harness (`harness.py`) waits for the HTTP-server slice."""
from .micro import bench_attention, bench_gemm, bench_gemv, roofline_report

__all__ = ["bench_gemm", "bench_gemv", "bench_attention", "roofline_report"]
