"""decode_step_ms.offline: the sum of cached_generate's decode seconds over
the sum of its decode steps, over the window's batches other than the
profiled one, in ms."""


def read(run):
    batches = [b for b in run.state.get("batches", []) if not b["traced"]]
    if not batches:
        return None
    steps = sum(b["out"].tokens.shape[1] for b in batches)
    return 1e3 * sum(b["out"].decode_s for b in batches) / steps
