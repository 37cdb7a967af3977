"""Tracing and profiling helpers (counterpart:
physics_llm_inference_tpu/utils/profiling.py).

- `trace(log_dir)`: `torch.profiler` around a block (host and, on the card,
  CUDA activity), written as a Chrome trace (`trace.json`) for
  chrome://tracing or Perfetto; the form of the JAX package's
  `jax.profiler.trace`.
- `device_memory_stats(device)`: the caching allocator's books from
  `torch.cuda.memory_stats`: bytes allocated and reserved (now and peak),
  the card's total, and the inactive split bytes that keep cached segments
  from being released, with the largest such block.
- `dispatch_overhead(iters)`: one tiny launch synced after each against
  `iters` launches enqueued and synced once, and the device's time a launch
  by CUDA events over the enqueued run.
- `fusion_benefit(...)`: an elementwise chain launched op by op against the
  same chain captured in one CUDA graph (the Hopper form of the JAX
  package's jit fusion: a replay removes the launches' host cost, it does
  not merge the kernels). On the CPU both forms run eagerly, and the result
  says so.

Every function takes `device` and runs on the card unless the caller asks
for the CPU; without CUDA a CUDA device raises.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


def _device(device) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block: `with trace(d): step()` writes `d/trace.json` (a
    new temporary directory when `log_dir` is None) and yields `d`."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or tempfile.mkdtemp(prefix="torch-trace-")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device=None) -> dict:
    """The allocator's books of a CUDA device (default: the current one):
    {"available": True, bytes_in_use, peak_bytes_in_use, bytes_limit,
    reserved_bytes, peak_reserved_bytes, inactive_split_bytes,
    largest_inactive_split_bytes}; {"available": False} on the CPU or
    without CUDA, as the JAX package reports a device without stats."""
    if device is not None and torch.device(device).type != "cuda":
        return {"available": False}
    if not torch.cuda.is_available():
        return {"available": False}
    dev = torch.device(device if device is not None else "cuda")
    st = torch.cuda.memory_stats(dev)
    largest = 0
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device") != (dev.index if dev.index is not None
                                 else torch.cuda.current_device()):
            continue
        blocks = seg.get("blocks", ())
        if any(b["state"] == "active_allocated" for b in blocks):
            largest = max([largest] + [b["size"] for b in blocks
                                       if b["state"] == "inactive"])
    return {
        "available": True,
        "bytes_in_use": st.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": st.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
        "reserved_bytes": st.get("reserved_bytes.all.current", 0),
        "peak_reserved_bytes": st.get("reserved_bytes.all.peak", 0),
        "inactive_split_bytes": st.get("inactive_split_bytes.all.current", 0),
        "largest_inactive_split_bytes": largest,
    }


def dispatch_overhead(iters: int = 50, device=None) -> dict:
    """Host microseconds a launch of a tiny add (an (8, 128) f32 tensor)
    synced after each, against `iters` launches enqueued and synced once;
    on the card also the device's microseconds a launch over the enqueued
    run (CUDA events)."""
    dev = _device(device)
    x = torch.zeros((8, 128), device=dev)
    y = x + 1.0
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        y = x + 1.0
        _sync(dev)
    synced = (time.perf_counter() - t0) / iters
    ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
          if dev.type == "cuda" else None)
    t0 = time.perf_counter()
    if ev:
        ev[0].record()
    y = x
    for _ in range(iters):
        y = y + 1.0
    if ev:
        ev[1].record()
    _sync(dev)
    pipelined = (time.perf_counter() - t0) / iters
    out = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "synced_us_per_dispatch": synced * 1e6,
        "pipelined_us_per_dispatch": pipelined * 1e6,
        "pipelining_speedup": synced / pipelined if pipelined else 0.0,
    }
    if ev:
        out["device_us_per_launch"] = ev[0].elapsed_time(ev[1]) * 1e3 / iters
    return out


def fusion_benefit(n_ops: int = 8, size: int = 1 << 20, iters: int = 20,
                   device=None) -> dict:
    """An elementwise chain of `n_ops` multiply-adds over `size` f32
    values launched op by op ("unfused") against the same chain captured in
    one CUDA graph and replayed ("fused"), ms a chain: CUDA events over
    `iters` chains on the card, the host clock on the CPU (where both run
    eagerly: "fused_form" says which)."""
    dev = _device(device)
    x = torch.ones((size // 128, 128), device=dev)

    def chain(t):
        for _ in range(n_ops):
            t = t * 1.0001 + 0.001
        return t

    unfused = fused = lambda: chain(x)   # noqa: E731
    form = "eager (no capture on the CPU)"
    if dev.type == "cuda":
        from ..runtime.step_cache import CapturedStep

        fused = CapturedStep(lambda: chain(x), dev)
        form = "cuda_graph"
    times = {}
    for name, fn in (("fused", fused), ("unfused", unfused)):
        fn()
        _sync(dev)
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(iters):
                fn()
            ev[1].record()
            _sync(dev)
            times[name] = ev[0].elapsed_time(ev[1]) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times[name] = (time.perf_counter() - t0) / iters * 1e3
    return {"fused_ms": times["fused"], "unfused_ms": times["unfused"],
            "fusion_speedup": (times["unfused"] / times["fused"]
                               if times["fused"] else 0.0),
            "fused_form": form}
