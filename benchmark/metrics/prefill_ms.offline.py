"""prefill_ms.offline: cached_generate's prefill seconds (GenerationOutput
.prefill_s, host clock after a synchronisation), the mean over the
window's batches other than the profiled one, in ms."""


def read(run):
    batches = [b for b in run.state.get("batches", []) if not b["traced"]]
    if not batches:
        return None
    return 1e3 * sum(b["out"].prefill_s for b in batches) / len(batches)
