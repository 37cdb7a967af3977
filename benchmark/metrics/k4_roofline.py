"""k4_roofline: K4's (fused_decode_step's) compulsory bytes over the card's
HBM bandwidth, divided by its device time, over the launches of the
profiled batch, in %. Launch i of a batch is decode step i: its bytes are
every layer's block weights at their width with their scales, the live
int8 KV of each row (prompt + i keys, with scales) read and one key a row
written (the architecture's Work.fused_decode_bytes). Where the trace
lost some launches' records, which step each remaining launch ran is not
known: each counts the mean step's bytes, and a log line counts them.
More launches than steps, or none, reads nothing."""
from benchmark.lib.dispatch import is_fused_decode


def read(run):
    sl, pk = run.slice, run.peaks
    if sl is None or pk is None or "batches" not in run.state:
        return None
    batch = next(b for b in run.state["batches"] if b["traced"])
    ops = [op for op in sl.ops_between(sl.t0, sl.t1) if is_fused_decode(op[2])]
    steps = run.mix["new_tokens"]
    if not ops or len(ops) > steps:
        run.log(f"k4_roofline: {len(ops)} launches traced, {steps} steps")
        return None
    lens = [len(p) for p in batch["prompts"]]
    nbytes = sum(run.work.fused_decode_bytes([n + i for n in lens])
                 for i in range(steps))
    if len(ops) < steps:
        run.log(f"k4_roofline: {len(ops)} of {steps} launches traced (the "
                f"trace lost records); each counts the mean step's bytes")
        nbytes = nbytes * len(ops) / steps
    secs = sum(e - s for s, e, _ in ops) / 1e9
    return 100.0 * nbytes / pk["hbm_bytes_s"] / secs
