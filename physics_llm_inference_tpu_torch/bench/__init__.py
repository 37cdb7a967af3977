"""Benchmarks (counterpart: physics_llm_inference_tpu/bench): the serving
harness and the kernel microbenchmarks."""
from .harness import (
    BenchmarkConfig, BenchmarkResult, run_benchmark, percentile,
)
from .micro import bench_attention, bench_gemm, bench_gemv, roofline_report

__all__ = [
    "BenchmarkConfig", "BenchmarkResult", "run_benchmark", "percentile",
    "bench_gemm", "bench_gemv", "bench_attention", "roofline_report",
]
