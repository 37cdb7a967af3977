"""mfu.offline: the whole step's share of the card's peak over the profiled
batch: for its prefill and each decode step that yields a token (the
last token comes from the step before it), the larger of model FLOPs over
the bf16 peak and compulsory bytes (weights once a step, live KV) over
HBM bandwidth, summed, over the batch's wall time, in %. Which bound
applied is logged."""
from benchmark.lib.arith import ideal_s


def read(run):
    pk = run.peaks
    if run.slice is None or pk is None or "batches" not in run.state:
        return None
    batch = next(b for b in run.state["batches"] if b["traced"])
    lens = [len(p) for p in batch["prompts"]]
    bound = {}
    work = run.work.prefill([(0, n) for n in lens])
    if work is None:
        return None
    total, by = ideal_s(*work, pk)
    bound["prefill"] = by
    for i in range(run.mix["new_tokens"] - 1):
        work = run.work.decode([n + i for n in lens])
        if work is None:
            return None
        t, by = ideal_s(*work, pk)
        total += t
        bound[f"decode_{by}"] = bound.get(f"decode_{by}", 0) + 1
    run.log(f"mfu.offline bounds: {bound}")
    h0, h1 = batch["host_ns"]
    return 100.0 * total / ((h1 - h0) / 1e9)
