"""mfu.serve_prefill: over the prefill dispatches of the profiled serving
slice, the larger of model FLOPs (valid tokens only) over the bf16 peak
and compulsory bytes (weights once a dispatch, the KV written and the
cached prefix read) over HBM bandwidth, summed, over the dispatches'
device time (first operation's start to last one's end), in %."""
from benchmark.lib.arith import ideal_s
from benchmark.lib.dispatch import device_span_s, dispatches


def read(run):
    if run.peaks is None:
        return None
    ideal = secs = 0.0
    for d, ops in dispatches(run):
        if d["kind"] != "prefill" or not d["chunks"]:
            continue
        work = run.work.prefill(d["chunks"])
        if work is None:
            return None
        ideal += ideal_s(*work, run.peaks)[0]
        secs += device_span_s(ops)
    if secs == 0:
        return None
    return 100.0 * ideal / secs
