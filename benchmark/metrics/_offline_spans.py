"""The offline entry's own spans (`generate.prefill`, `generate.decode`
and the dropless prefill's `moe.prefill_route`, recorded by the program in
physics_llm_inference_tpu_torch/utils/tracing.py's ring) of the traced
batch of an offline run, and the device operations inside a phase.

Every function returns None where the program keeps no such spans (a
program without them reads nothing here, and does not raise)."""
from __future__ import annotations


def traced_batch(run):
    return next((b for b in run.state.get("batches", []) if b["traced"]),
                None)


def spans(run, name: str) -> list | None:
    """The program's spans called `name` inside the traced batch's host
    interval, oldest first; None without a traced batch or a ring."""
    batch = traced_batch(run)
    if batch is None:
        return None
    try:
        from physics_llm_inference_tpu_torch.utils import tracing
    except ImportError:
        return None
    h0, h1 = batch["host_ns"]
    return [s for s in tracing.RECORDER.snapshot().spans
            if s.name == name and s.start_ns >= h0 and s.end_ns <= h1]


def phase_ops(run, name: str, match) -> list | None:
    """The traced slice's device operations whose name `match` accepts,
    started inside the traced batch's one span `name` (mapped onto the
    trace's clock with Slice.host_ns); None, with a log line, where the
    slice or the span is missing."""
    sl = run.slice
    if sl is None:
        return None
    found = spans(run, name)
    if not found or len(found) != 1:
        run.log(f"{name}: {0 if not found else len(found)} spans of the "
                f"traced batch, 1 expected")
        return None
    a, b = sl.host_ns(found[0].start_ns), sl.host_ns(found[0].end_ns)
    return [op for op in sl.ops_between(a, b) if match(op[2])]
