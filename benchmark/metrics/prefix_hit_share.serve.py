"""prefix_hit_share.serve: prompt tokens the radix cache served (the
engine's `radix_hit_tokens` counter, its change over the window) over the
prompt tokens submitted in the window, in %. In a traced run both stop
where the profile stops (clients/open_loop.py)."""


def read(run):
    st = run.state
    if "stats1" not in st:
        return None
    hits = st["stats1"]["radix_hit_tokens"] - st["stats0"]["radix_hit_tokens"]
    submitted = sum(len(r["prompt"]) for r in st["counted"])
    return 100.0 * hits / submitted
