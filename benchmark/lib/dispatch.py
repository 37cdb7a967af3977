"""The serving slice's device operations by engine dispatch.

The open-loop client stamps each prefill and decode dispatch's host start
(trace runs only). A dispatch's operations are those that start on the
device from its stamp until the next dispatch's stamp: its captured step
and what the engine runs on its result before the next dispatch (the first
token's sampling after a prefill). Decode dispatches read their result
back before returning, so nothing of one lands in the next.
"""
from __future__ import annotations


def dispatches(run) -> list:
    """[(span, ops)] for every dispatch stamped inside the traced slice."""
    sl = run.slice
    if sl is None:
        return []
    spans = sorted(run.state.get("dispatches", []), key=lambda d: d["t"])
    out = []
    for i, d in enumerate(spans):
        a = sl.host_ns(d["t"])
        b = sl.host_ns(spans[i + 1]["t"]) if i + 1 < len(spans) else sl.t1
        if a >= sl.t0 and b <= sl.t1:
            out.append((d, sl.ops_between(a, b)))
    return out


def device_span_s(ops: list) -> float:
    """Seconds from the first operation's start to the last one's end."""
    if not ops:
        return 0.0
    return (max(e for _, e, _ in ops) - ops[0][0]) / 1e9


def is_fused_decode(name: str) -> bool:
    return "fused_decode_stream_kernel" in name


def is_linear(name: str) -> bool:
    """K1's kernels and the library's GEMMs (prefill linears on cast
    weights)."""
    low = name.lower()
    return "int8_matmul" in low or any(
        k in low for k in ("gemm", "nvjet", "cutlass", "xmma"))
