"""The yardstick's arithmetic that belongs to no architecture:
percentiles, the card's peaks, and the least time of a step's operations
and bytes on the card. Each architecture counts its own operations and
bytes (`Work` in benchmark/arch/<model_type>.py).
"""
from __future__ import annotations

import json
from pathlib import Path

_PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"


def percentile(values: list, p: float) -> float:
    """The value at the rounded index p/100 x (n - 1) of the sorted values
    (the repository's bench/harness.py rule)."""
    if not values:
        return float("nan")
    vs = sorted(values)
    return vs[min(len(vs) - 1, int(round((p / 100) * (len(vs) - 1))))]


def peaks(device_name: str) -> dict | None:
    """The published peaks of a card by its torch name, or None."""
    with open(_PEAKS) as f:
        return json.load(f)["cards"].get(device_name)


def ideal_s(flops: float, nbytes: float, pk: dict) -> tuple[float, str]:
    """The least time of (FLOPs, bytes) on the card, and which bound."""
    tf, tb = flops / pk["bf16_flops"], nbytes / pk["hbm_bytes_s"]
    return (tf, "flops") if tf >= tb else (tb, "bytes")
