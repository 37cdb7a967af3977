"""output_tok_s: generated tokens of every batch started in the window,
over the wall time from the first batch's start to the last one's end
(prefill included), host clock after the device's synchronisation."""


def read(run):
    e = run.e2e
    if "output_tokens" not in e or e["wall_s"] <= 0:
        return None
    return e["output_tokens"] / e["wall_s"]
