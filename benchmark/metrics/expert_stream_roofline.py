"""expert_stream_roofline: the grouped expert kernels' compulsory bytes
(the int8 routed expert weights and scales of the experts a decode step's
rows are routed to, every MoE layer: the architecture's
Work.expert_bytes, whose count of experts touched is the expectation
under uniform routing where not every expert is sure to be) over the
card's HBM bandwidth, divided by those kernels' device time
(`moe_expert_stream_kernel` and `moe_expert_finalize_kernel`, two pairs a
layer) over the traced batch's decode (its `generate.decode` span), in
%. Where the trace lost some stream kernels' records, the bytes count the
launches kept, with a log line; none, or more than two a layer and step,
reads nothing."""
from benchmark.metrics import _offline_spans


def read(run):
    pk = run.peaks
    moe_layers = getattr(run.work, "moe_layers", 0)
    if pk is None or not moe_layers:
        return None
    ops = _offline_spans.phase_ops(
        run, "generate.decode",
        lambda n: "moe_expert_stream_kernel" in n
        or "moe_expert_finalize_kernel" in n)
    if ops is None:
        return None
    streams = sum("moe_expert_stream_kernel" in n for _, _, n in ops)
    steps = run.mix["new_tokens"]
    expected = 2 * moe_layers * steps
    if not streams or streams > expected:
        run.log(f"expert_stream_roofline: {streams} stream launches traced, "
                f"{expected} expected")
        return None
    rows = len(_offline_spans.traced_batch(run)["prompts"])
    nbytes = steps * moe_layers * run.work.expert_bytes(rows)
    if streams < expected:
        run.log(f"expert_stream_roofline: {streams} of {expected} launches "
                f"traced; the bytes of those")
        nbytes *= streams / expected
    secs = sum(e - s for s, e, _ in ops) / 1e9
    return 100.0 * nbytes / pk["hbm_bytes_s"] / secs
