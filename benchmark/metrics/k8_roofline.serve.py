"""k8_roofline.serve: K8's (fused_paged_decode_step's) compulsory bytes
over the card's HBM bandwidth, divided by its device time, over the decode
dispatches of the profiled serving slice, in %. Launch j of a dispatch
reads every layer's block weights and the live int8 KV of the rows that
decode in it (each row's length + j keys) and writes one key a row."""
from benchmark.lib.dispatch import dispatches, is_fused_decode


def read(run):
    if run.peaks is None:
        return None
    nbytes = secs = 0.0
    for d, ops in dispatches(run):
        if d["kind"] != "decode":
            continue
        k8 = [op for op in ops if is_fused_decode(op[2])]
        if len(k8) != d["horizon"]:
            continue
        nbytes += sum(run.work.fused_decode_bytes(
            [n + j for n in d["lengths"]]) for j in range(d["horizon"]))
        secs += sum(e - s for s, e, _ in k8) / 1e9
    if secs == 0:
        return None
    return 100.0 * nbytes / run.peaks["hbm_bytes_s"] / secs
