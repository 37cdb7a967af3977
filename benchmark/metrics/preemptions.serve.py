"""preemptions.serve: requests the scheduler preempted in the window (the
change of its `preempted` counter); in a traced run, until the profile
stops."""


def read(run):
    st = run.state
    if "stats1" not in st:
        return None
    return (st["stats1"]["scheduler"]["preempted"]
            - st["stats0"]["scheduler"]["preempted"])
