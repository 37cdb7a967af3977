"""setup_s: seconds from the process's start to the first timed work
(weights, build, capture, warm-up), host clock."""


def read(run):
    return run.setup_s
