"""ttft_p95_ms: the 95th percentile, over every request that arrived in
the window, of the time from its due time on the arrival schedule to the
first token the client received; a missing request counts its whole wait."""
from benchmark.lib.arith import percentile


def read(run):
    if "ttft_s" not in run.e2e:
        return None
    return percentile(run.e2e["ttft_s"], 95) * 1e3
