"""idle_share.serve: the share of the profiled serving slice in which no
operation ran on the device (torch.profiler), in %."""


def read(run):
    if run.slice is None or "requests" not in run.state:
        return None
    return 100.0 * (1.0 - run.slice.busy_s() / run.slice.window_s())
