"""admit_to_first_p95_ms.serve: the 95th percentile (rounded index) of the
program's `request.first_token` spans (first admission to the first token)
over the window's requests whose first token came before the profile
stopped, in ms; none below 200 requests."""
from benchmark.metrics._program_spans import request_p95_ms


def read(run):
    return request_p95_ms(run, "request.first_token")
