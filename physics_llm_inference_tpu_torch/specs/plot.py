"""Roofline plotting (counterpart: physics_llm_inference_tpu/specs/plot.py).

A log-log roofline of a `GPUSpec` with labelled workload points. matplotlib
is imported inside the function, and where it is missing the function
returns the computed series so callers can plot elsewhere.
"""
from __future__ import annotations

from .gpu import GPUSpec
from .roofline import ridge_point, roofline_throughput


def plot_roofline(spec: GPUSpec, points: dict[str, float] | None = None,
                  dtype: str = "bf16", save_path: str | None = None):
    """points: {label: arithmetic_intensity}. Returns (ai_axis, perf_axis,
    point_perf) and saves a figure to `save_path` when matplotlib is
    available."""
    import numpy as np

    ai_axis = np.logspace(-1, 4, 200)
    perf = np.array([roofline_throughput(a, spec, dtype) for a in ai_axis])
    points = points or {}
    point_perf = {name: roofline_throughput(ai, spec, dtype)
                  for name, ai in points.items()}

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return ai_axis, perf, point_perf

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.loglog(ai_axis, perf / 1e12, label=f"{spec.name} {dtype} roofline")
    ridge = ridge_point(spec, dtype)
    ax.axvline(ridge, linestyle="--", alpha=0.5,
               label=f"ridge {ridge:.0f} FLOP/B")
    for name, ai in points.items():
        ax.plot(ai, point_perf[name] / 1e12, "o")
        ax.annotate(name, (ai, point_perf[name] / 1e12),
                    textcoords="offset points", xytext=(5, 5))
    ax.set_xlabel("arithmetic intensity (FLOP/byte)")
    ax.set_ylabel("attainable TFLOP/s")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return ai_axis, perf, point_perf
