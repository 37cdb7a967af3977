"""idle_share.serve_results: the share of the profiled serving slice in
which no device operation ran while the engine's thread was inside a
`prefill.results`, `decode.results` or `retire` span (reading tokens back,
handing them to the listeners, retiring), in %."""
from benchmark.metrics._program_spans import idle_split


def read(run):
    split = idle_split(run)
    return None if split is None else split["results"]
