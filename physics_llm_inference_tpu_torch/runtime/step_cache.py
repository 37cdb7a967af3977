"""Shape buckets and the step cache (counterpart:
physics_llm_inference_tpu/runtime/step_cache.py).

The JAX package compiles a jitted step once per shape bucket; replaying it
is calling it. On the card the same role is played by a CUDA graph, the
form of the reference's `CUDAGraphRunner` (ch08/cuda_graph.py:18-82):
static buffers, a warm-up, one capture, then `replay()` after the inputs
are copied into the static buffers. `StepCache` memoizes whatever its
`make_fn` returns per key, as the JAX one does; on CUDA a make_fn returns
`CapturedStep`s, on the CPU the eager callables.

A replay calls no Python, so the kernels' launch counters (module-level
integers named `*launches` that each wrapper bumps where it launches) would
not move: a `CapturedStep` records each counter's change during its capture
and adds it on every replay. The capture itself launches nothing and is
not counted; the warm-up before it launches, and is.

`capture_s` counts the seconds the `CapturedStep`s made in the process
took to warm up and capture, each timed between two synchronizations of
the device, less the kernel library's build and load when a warm-up's
first launch triggered it (`_build.load_s`): set-up's cost; a replay does
not move it.
"""
from __future__ import annotations

import importlib
import time
from typing import Callable, Sequence

import torch

from ..kernels import _build

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
DEFAULT_SEQ_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
# the kernel modules whose launch counters a replay must move
_KERNEL_MODULES = ("flash_attention", "fused_decode", "hello_pallas",
                   "int8_kv_attention", "int8_matmul", "lmhead", "matmul",
                   "membench", "paged_attention")
capture_s = 0.0


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; raises if n exceeds the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


class StepCache:
    """Memoize step functions per shape-bucket key: `make_fn(*key)` runs on
    a miss; `stats()` reports the shapes made, hits and misses, as the JAX
    package's cache reports its compiles."""

    def __init__(self, make_fn: Callable):
        self._make_fn = make_fn
        self._cache: dict = {}
        self.hits = 0
        self.misses = 0

    def get(self, *key):
        if key not in self._cache:
            self._cache[key] = self._make_fn(*key)
            self.misses += 1
        else:
            self.hits += 1
        return self._cache[key]

    def stats(self) -> dict:
        return {"compiled_shapes": len(self._cache), "hits": self.hits,
                "misses": self.misses}


def _launch_counters() -> dict:
    """{(module, name): value} of every kernel launch counter."""
    out = {}
    for name in _KERNEL_MODULES:
        mod = importlib.import_module(f"..kernels.{name}", __package__)
        for attr, val in vars(mod).items():
            if attr.endswith("launches") and type(val) is int:
                out[mod, attr] = val
    return out


class CapturedStep:
    """`fn()` captured into a CUDA graph. `fn` reads and writes only
    tensors that outlive the graph (its static inputs, outputs and state);
    what it returns is the step's static output, overwritten by each
    replay.

    At construction `fn` runs once eagerly on a side stream (kernel builds,
    the allocator's blocks), then once under capture. Each graph captures
    into a memory pool of its own: what `fn` allocates during capture (its
    intermediates, its kernels' scratch, its static output) lives in that
    pool for the graph's life, and no other graph's replay or eager launch
    writes it. (A pool shared by several graphs is safe only while they
    replay in capture order: a graph captured later may place its static
    output in blocks an earlier graph uses for intermediates.) The warm-up
    runs on whatever the static buffers hold: the owner fills them with
    values whose writes are harmless first. `generators`: the
    `torch.Generator`s `fn` draws from, registered with the graph so each
    replay advances them. A capture that fails raises."""

    def __init__(self, fn: Callable, device, generators=()):
        global capture_s
        device = torch.device(device)
        torch.cuda.synchronize(device)
        t0, loaded = time.perf_counter(), _build.load_s
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()
        main.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            if gen is not None:
                self.graph.register_generator_state(gen)
        before = _launch_counters()
        with torch.cuda.graph(self.graph):
            self.out = fn()
        after = _launch_counters()
        for (mod, attr), val in before.items():
            setattr(mod, attr, val)
        self.launches = {k: after[k] - v for k, v in before.items()
                         if after[k] != v}
        torch.cuda.synchronize(device)
        capture_s += time.perf_counter() - t0 - (_build.load_s - loaded)

    def __call__(self):
        """Replay the graph; returns the static output."""
        self.graph.replay()
        for (mod, attr), n in self.launches.items():
            setattr(mod, attr, getattr(mod, attr) + n)
        return self.out


class StagedInputs:
    """Static input buffers of a dispatch step and, on CUDA, pinned host
    staging for them: `load(name=array, ...)` writes each host array into
    its pinned buffer and copies it to the static one on the current
    stream without holding the host. Before a pinned buffer is written
    again, the host waits for the copy out of it that the previous load
    queued."""

    def __init__(self, device, **buffers: torch.Tensor):
        self.device = torch.device(device)
        self.buffers = buffers
        self._pinned = self._copied = None
        if self.device.type == "cuda":
            self._pinned = {k: torch.empty(v.shape, dtype=v.dtype,
                                           pin_memory=True)
                            for k, v in buffers.items()}
            self._copied = torch.cuda.Event()

    def load(self, **arrays) -> None:
        if self._pinned is None:
            for k, a in arrays.items():
                self.buffers[k].copy_(torch.as_tensor(a))
            return
        self._copied.synchronize()
        for k, a in arrays.items():
            self._pinned[k].numpy()[...] = a
            self.buffers[k].copy_(self._pinned[k], non_blocking=True)
        self._copied.record()


def staged_step(fn: Callable, device, generators=(),
                capture: bool = True, **buffers: torch.Tensor):
    """A serving engine's dispatch step over static input buffers: returns
    (inputs, step), where `inputs` is the StagedInputs over `buffers` and
    `step()` runs `fn(**buffers)`: captured on CUDA (the capture
    warms `fn` up on the buffers' initial values, so those must make its
    writes harmless), `fn` itself, eagerly, on the CPU or with
    `capture=False` (a step that runs collectives of a mesh)."""
    device = torch.device(device)
    inputs = StagedInputs(device, **buffers)

    def run():
        return fn(**inputs.buffers)

    if device.type != "cuda" or not capture:
        return inputs, run
    return inputs, CapturedStep(run, device, generators)
