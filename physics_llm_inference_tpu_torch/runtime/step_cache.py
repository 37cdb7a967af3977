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
"""
from __future__ import annotations

import importlib
from typing import Callable, Sequence

import torch

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
DEFAULT_SEQ_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
# the kernel modules whose launch counters a replay must move
_KERNEL_MODULES = ("flash_attention", "fused_decode", "hello_pallas",
                   "int8_kv_attention", "int8_matmul", "lmhead", "matmul",
                   "membench", "paged_attention")


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
    workspaces that launchers keep, the allocator's blocks), then once under
    capture into `pool` (a `torch.cuda.graph_pool_handle()` shared by the
    graphs of one owner). The warm-up runs on whatever the static buffers
    hold: the owner fills them with values whose writes are harmless first.
    `generators`: the `torch.Generator`s `fn` draws from, registered with
    the graph so each replay advances them. A capture that fails raises."""

    def __init__(self, fn: Callable, device, pool=None, generators=()):
        device = torch.device(device)
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
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = fn()
        after = _launch_counters()
        for (mod, attr), val in before.items():
            setattr(mod, attr, val)
        self.launches = {k: after[k] - v for k, v in before.items()
                         if after[k] != v}

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


def staged_step(fn: Callable, device, pool=None, generators=(),
                capture: bool = True, **buffers: torch.Tensor):
    """A serving engine's dispatch step over static input buffers: returns
    (inputs, step), where `inputs` is the StagedInputs over `buffers` and
    `step()` runs `fn(**buffers)`: captured into `pool` on CUDA (the capture
    warms `fn` up on the buffers' initial values, so those must make its
    writes harmless), `fn` itself, eagerly, on the CPU or with
    `capture=False` (a step that runs collectives of a mesh)."""
    device = torch.device(device)
    inputs = StagedInputs(device, **buffers)

    def run():
        return fn(**inputs.buffers)

    if device.type != "cuda" or not capture:
        return inputs, run
    return inputs, CapturedStep(run, device, pool, generators)
