"""mla_decode_roofline: the MLA decode kernel's compulsory bytes (each
row's live int8 latent codes and scales, its absorbed bf16 queries and its
bf16 output, every layer: the architecture's Work.mla_decode_bytes) over
the card's HBM bandwidth, divided by the kernel's device time (both
launches, `mla_decode_split_kernel` and `mla_decode_combine_kernel`), over
the traced batch's decode (its `generate.decode` span), in %. Step i of a
batch reads prompt + i cached keys and its new one. Where the trace lost
some of the split kernel's records, the bytes count the launches kept
(each at the mean step's), with a log line; none, or more than the steps'
layers, reads nothing."""
from benchmark.metrics import _offline_spans


def read(run):
    pk = run.peaks
    if pk is None or not hasattr(run.work, "mla_decode_bytes"):
        return None
    ops = _offline_spans.phase_ops(run, "generate.decode",
                                   lambda n: "mla_decode" in n)
    if ops is None:
        return None
    splits = sum("mla_decode_split" in n for _, _, n in ops)
    steps = run.mix["new_tokens"]
    expected = steps * run.work.L
    if not splits or splits > expected:
        run.log(f"mla_decode_roofline: {splits} launches traced, "
                f"{expected} expected")
        return None
    lens = [len(p) for p in _offline_spans.traced_batch(run)["prompts"]]
    nbytes = sum(run.work.mla_decode_bytes([n + i for n in lens])
                 for i in range(steps))
    if splits < expected:
        run.log(f"mla_decode_roofline: {splits} of {expected} launches "
                f"traced; the bytes of those")
        nbytes *= splits / expected
    secs = sum(e - s for s, e, _ in ops) / 1e9
    return 100.0 * nbytes / pk["hbm_bytes_s"] / secs
