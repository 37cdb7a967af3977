"""idle_share.offline: the share of the profiled batch's time in which no
operation ran on the device (torch.profiler), in %."""


def read(run):
    if run.slice is None or "batches" not in run.state:
        return None
    return 100.0 * (1.0 - run.slice.busy_s() / run.slice.window_s())
