"""idle_share.serve_outside_step: the share of the profiled serving slice
in which no device operation ran and no `engine.step` span was open (the
serving loop between steps, waiting for the engine's lock), in %."""
from benchmark.metrics._program_spans import idle_split


def read(run):
    split = idle_split(run)
    return None if split is None else split["outside_step"]
