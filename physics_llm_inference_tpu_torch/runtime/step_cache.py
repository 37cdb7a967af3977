"""Shape buckets (counterpart: physics_llm_inference_tpu/runtime/step_cache.py:15-26).

Only the bucketing policy is ported; `StepCache` (compiled-step memo) waits
for the CUDA-graph work.
"""
from __future__ import annotations

from typing import Sequence

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
DEFAULT_SEQ_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; raises if n exceeds the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")
