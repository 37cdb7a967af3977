"""mla_prefill_roofline: the MLA prefill attention's compulsory FLOPs (the
causal (query, key) pairs of valid tokens, 2 x pairs x heads x (192 + 128)
a layer: the architecture's Work.mla_prefill_flops) over the card's bf16
peak, divided by K5's device time (`flash_attention_kernel`) inside the
traced batch's prefill (its `generate.prefill` span), in %."""
from benchmark.metrics import _offline_spans


def read(run):
    pk = run.peaks
    if pk is None or not hasattr(run.work, "mla_prefill_flops"):
        return None
    ops = _offline_spans.phase_ops(run, "generate.prefill",
                                   lambda n: "flash_attention_kernel" in n)
    if not ops:
        if ops is not None:
            run.log("mla_prefill_roofline: no K5 launch in the prefill")
        return None
    lens = [len(p) for p in _offline_spans.traced_batch(run)["prompts"]]
    flops = run.work.mla_prefill_flops([(0, n) for n in lens])
    secs = sum(e - s for s, e, _ in ops) / 1e9
    return 100.0 * flops / pk["bf16_flops"] / secs
