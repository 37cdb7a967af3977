"""prefill_gemm_roofline.serve: the FLOPs the prefill dispatches' linears
need (the four block matrices of every valid token of every chunk, and
the head on each chunk's last token; padding rows and columns left out)
over the card's bf16 peak, divided by the device time of their kernels
(K1's and the library's GEMMs on cast weights), over the profiled serving
slice, in %."""
from benchmark.lib.dispatch import dispatches, is_linear


def read(run):
    if run.peaks is None:
        return None
    flops = secs = 0.0
    for d, ops in dispatches(run):
        if d["kind"] != "prefill":
            continue
        flops += run.work.prefill_linear_flops(d["chunks"])
        secs += sum(e - s for s, e, name in ops if is_linear(name)) / 1e9
    if secs == 0:
        return None
    return 100.0 * flops / run.peaks["bf16_flops"] / secs
