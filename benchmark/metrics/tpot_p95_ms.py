"""tpot_p95_ms: the 95th percentile over the window's requests of (last
token's time - first token's time) / (tokens - 1), as the client saw them."""
from benchmark.lib.arith import percentile


def read(run):
    if not run.e2e.get("tpot_s"):
        return None
    return percentile(run.e2e["tpot_s"], 95) * 1e3
