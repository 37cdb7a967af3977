"""expert_rows_max_over_mean.prefill: how unevenly the traced batch's
prefill routes its tokens: over the dropless prefill's `moe.prefill_route`
spans inside the batch's `generate.prefill` span (one an MoE layer and
prefill slice; attributes counted on the host before the expert
products), the mean of the largest expert's routed rows over the mean
rows an expert. 1 is perfectly even; the largest expert's products set
the layer's time."""
from benchmark.metrics import _offline_spans


def read(run):
    pre = _offline_spans.spans(run, "generate.prefill")
    routes = _offline_spans.spans(run, "moe.prefill_route")
    if not pre or not routes:
        return None
    a, b = pre[0].start_ns, pre[0].end_ns
    ratios = [s.attrs["rows_max"] / s.attrs["rows_mean"] for s in routes
              if a <= s.start_ns and s.end_ns <= b and s.attrs["rows_mean"]]
    if not ratios:
        return None
    return sum(ratios) / len(ratios)
