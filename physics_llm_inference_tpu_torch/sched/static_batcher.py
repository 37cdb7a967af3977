"""Static batching baseline + padding-waste analysis (a copy of
physics_llm_inference_tpu/sched/static_batcher.py:13-66).

Pure Python. Copied, not imported: the JAX package's `sched/__init__.py`
imports jax (through `sched/request.py`), and the port imports nothing of
it. Keep the two line for line.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class StaticBatch:
    prompt_lens: list[int]
    padded_len: int

    @property
    def real_tokens(self) -> int:
        return sum(self.prompt_lens)

    @property
    def padded_tokens(self) -> int:
        return len(self.prompt_lens) * self.padded_len

    @property
    def efficiency(self) -> float:
        """real/padded (ref :45-65)."""
        return self.real_tokens / self.padded_tokens if self.padded_tokens else 0.0


class StaticBatcher:
    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.queue: list[list[int]] = []

    def add(self, prompt: list[int]) -> None:
        self.queue.append(prompt)

    def next_batch(self) -> StaticBatch | None:
        """Form a pad-to-max batch when enough requests queue (ref :27-43)."""
        if len(self.queue) < self.batch_size:
            return None
        prompts, self.queue = (self.queue[:self.batch_size],
                               self.queue[self.batch_size:])
        lens = [len(p) for p in prompts]
        return StaticBatch(prompt_lens=lens, padded_len=max(lens))


def analyze_static_batching_waste(prompt_lens: list[int],
                                  batch_size: int) -> dict:
    """Padding waste over a workload (ref analyze_static_batching_waste
    :71-109)."""
    total_real = 0
    total_padded = 0
    for i in range(0, len(prompt_lens) - batch_size + 1, batch_size):
        chunk = prompt_lens[i:i + batch_size]
        total_real += sum(chunk)
        total_padded += max(chunk) * len(chunk)
    waste = total_padded - total_real
    return {
        "real_tokens": total_real,
        "padded_tokens": total_padded,
        "wasted_tokens": waste,
        "waste_fraction": waste / total_padded if total_padded else 0.0,
    }
