"""mfu.serve_decode: over the decode dispatches of the profiled serving
slice, for each of a dispatch's steps the larger of model FLOPs over the
bf16 peak and compulsory bytes (weights once a step, the live KV of the
rows that decode) over HBM bandwidth, summed, over the dispatches' device
time (first operation's start to last one's end), in %."""
from benchmark.lib.arith import ideal_s
from benchmark.lib.dispatch import device_span_s, dispatches


def read(run):
    if run.peaks is None:
        return None
    ideal = secs = 0.0
    for d, ops in dispatches(run):
        if d["kind"] != "decode" or not d["lengths"]:
            continue
        for j in range(d["horizon"]):
            work = run.work.decode([n + j for n in d["lengths"]])
            if work is None:
                return None
            ideal += ideal_s(*work, run.peaks)[0]
        secs += device_span_s(ops)
    if secs == 0:
        return None
    return 100.0 * ideal / secs
