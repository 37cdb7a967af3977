"""moe_ffn_roofline: the expert FFN's compulsory bytes (the router gate and
the int8 expert weights and scales of the experts the step's tokens were
routed to, read once a step) over the card's HBM bandwidth, divided by
the FFN's device time, over the profiled batch's decode steps, in %.

The FFN's kernels are found by their place in a per-op decode layer:
after K2 (int8_kv_decode_attention) comes K1 on wo (its stream kernel,
then int8_matmul_finalize); from there to the next K1 stream kernel (the
next layer's wqkv) or K3 (lmhead_greedy's rmsnorm_rows) run the residual
add, ln2, the router, the dispatch, the grouped expert kernels (w1 and w3
in one moe_expert_stream_kernel launch and its moe_expert_finalize_kernel,
then w2's pair), the combine, the residual add and the next ln1: all of
it counts as FFN time, so the share errs low by the two adds and norms.
The prefill runs no K2, so its expert products (dequantized stacks and
bmm) open no region. A trace can lose records: a region whose K2, wo
finalize or closing launch is missing is left out, and the share is read
over the regions traced whole, with a log line that counts them. Each
reason to read nothing is logged; more regions than layer-steps, or
none, is one."""


def read(run):
    sl, pk = run.slice, run.peaks
    if sl is None:
        run.log("moe_ffn_roofline: no profiled slice")
        return None
    if pk is None:
        run.log("moe_ffn_roofline: no peaks for this card")
        return None
    if "batches" not in run.state:
        run.log("moe_ffn_roofline: no offline batch in the run")
        return None
    batch = next(b for b in run.state["batches"] if b["traced"])
    rows = len(batch["prompts"])
    per_step = run.work.expert_bytes(rows)
    if per_step is None:
        run.log(f"moe_ffn_roofline: the experts {rows} rows touch are not "
                f"known without the program's routing")
        return None
    regions, state, cur = [], 0, 0
    for s, e, name in sl.ops_between(sl.t0, sl.t1):
        if state == 2:
            if ("int8_matmul_stream" in name or "rmsnorm_rows" in name
                    or "lmhead" in name):
                regions.append(cur)
                state = 0
            else:
                cur += e - s
        if "int8_kv_decode_attention" in name:
            state = 1
        elif state == 1 and "int8_matmul_finalize" in name:
            state, cur = 2, 0
    expected = run.work.L * run.mix["new_tokens"]
    if not regions or len(regions) > expected:
        run.log(f"moe_ffn_roofline: {len(regions)} FFN regions traced, "
                f"{expected} expected")
        return None
    if len(regions) < expected:
        run.log(f"moe_ffn_roofline: {len(regions)} of {expected} FFN "
                f"regions traced whole (the trace lost records); read over "
                f"those")
    gate = run.work.d * run.work.e * 2
    nbytes = len(regions) * (per_step + gate)
    return 100.0 * nbytes / pk["hbm_bytes_s"] / (sum(regions) / 1e9)
