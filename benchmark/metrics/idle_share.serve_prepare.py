"""idle_share.serve_prepare: the share of the profiled serving slice in
which no device operation ran while the engine's thread was inside an
`engine.step` span and outside its results spans (scheduling, staging,
preparing the decode, launching), in %. With idle_share.serve_results and
idle_share.serve_outside_step it adds up to idle_share.serve."""
from benchmark.metrics._program_spans import idle_split


def read(run):
    split = idle_split(run)
    return None if split is None else split["prepare"]
