"""queue_wait_p95_ms.serve: the 95th percentile (rounded index) of the
program's `request.queued` spans (submit to first admission) over the
window's requests admitted before the profile stopped (the slice's end on
the host clock, which leaves out the seconds stopping the profiler holds
the loop), in ms; none below 200 requests."""
from benchmark.metrics._program_spans import request_p95_ms


def read(run):
    return request_p95_ms(run, "request.queued")
