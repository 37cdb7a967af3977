"""The program's own spans (physics_llm_inference_tpu_torch/utils/
tracing.py, an always-on ring of spans on `time.time_ns()`'s clock) read
against a traced serving run: the profiled slice's idle time split by where
the engine's thread was, and the window's request spans.

Every reader returns None where the program keeps no such spans, or where
its ring has dropped spans the reading needs.
"""
from __future__ import annotations

from bisect import bisect_right

from benchmark.lib.arith import percentile

RESULTS = ("prefill.results", "decode.results", "retire")
LEAST_REQUESTS = 200


def _snapshot():
    try:
        from physics_llm_inference_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.RECORDER.snapshot()


def _gaps(sl) -> list:
    """[start, end) of the slice's stretches with no device operation, on
    the trace's clock (they add up to Slice.busy_s's complement)."""
    gaps, end = [], sl.t0
    for s, e, _ in sl.device:
        if e <= end:
            continue
        if s > end:
            gaps.append((end, min(s, sl.t1)))
        end = e
        if end >= sl.t1:
            break
    if end < sl.t1:
        gaps.append((end, sl.t1))
    return gaps


def _overlap(gaps: list, spans: list) -> int:
    """ns of `gaps` that `spans` (disjoint intervals) cover."""
    starts = [a for a, _ in gaps]
    total = 0
    for a, b in spans:
        i = max(0, bisect_right(starts, a) - 1)
        while i < len(gaps) and gaps[i][0] < b:
            total += max(0, min(b, gaps[i][1]) - max(a, gaps[i][0]))
            i += 1
    return total


def idle_split(run) -> dict | None:
    """{prepare, results, outside_step}: shares (%) of the profiled slice
    with no device operation running while the engine's thread was inside
    an `engine.step` and outside its results spans (`RESULTS`), inside
    one of those, or outside every `engine.step`; they add up to
    idle_share.serve."""
    sl = run.slice
    if sl is None or "requests" not in run.state:
        return None
    snap = _snapshot()
    if snap is None:
        return None
    t0, t1 = sl.t0 - sl.offset, sl.t1 - sl.offset      # host clock
    if snap.complete_from_ns >= t0:
        return None
    steps, results = [], []
    for s in snap.spans:
        if s.end_ns > t0 and s.start_ns < t1:
            if s.name == "engine.step":
                steps.append((sl.host_ns(s.start_ns), sl.host_ns(s.end_ns)))
            elif s.name in RESULTS:
                results.append((sl.host_ns(s.start_ns),
                                sl.host_ns(s.end_ns)))
    if not steps:
        return None
    gaps = _gaps(sl)
    idle = sum(b - a for a, b in gaps)
    in_step, in_results = _overlap(gaps, steps), _overlap(gaps, results)
    share = 100.0 / (sl.t1 - sl.t0)
    return {"prepare": share * (in_step - in_results),
            "results": share * in_results,
            "outside_step": share * (idle - in_step)}


def request_p95_ms(run, name: str) -> float | None:
    """p95 (rounded index) of the window's `name` request spans that ended
    before the profile stopped, in ms; None below LEAST_REQUESTS."""
    sl, reqs = run.slice, run.state.get("requests")
    if sl is None or not reqs:
        return None
    snap = _snapshot()
    if snap is None:
        return None
    window = {r["id"]: r for r in reqs if "id" in r}
    mine = [s for s in snap.spans if s.name == name and s.key in window]
    if not mine:
        return None
    if snap.overwritten:
        # the window's start on the spans' clock, from a request's submit
        # (perf_counter) and its `request.queued` start
        q = next((s for s in snap.spans if s.name == "request.queued"
                  and s.key in window), None)
        if q is None or snap.complete_from_ns >= (
                q.start_ns + 1e9 * (run.state["start"]
                                    - window[q.key]["submitted"])):
            return None
    stopped = sl.t1 - sl.offset
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in mine if s.end_ns <= stopped]
    if len(ms) < LEAST_REQUESTS:
        return None
    return percentile(ms, 95)
