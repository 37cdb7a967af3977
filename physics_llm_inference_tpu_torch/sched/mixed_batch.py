"""Mixed prefill+decode batch former (ref ch08/mixed_batch.py:42-129).

Builds one iteration's batch mixing prefill chunks and decode steps under a
token budget: prefill gets `max_batch_tokens * prefill_priority` (capped by
max_prefill_tokens), decode fills the remainder up to max_decode_batch
(ref :69-94). The runner executes the decode sub-batch and each prefill chunk
as separate fixed-shape dispatches; this module only decides membership.

A copy of physics_llm_inference_tpu/sched/mixed_batch.py, line for line: the
original's package imports jax (through `sched/request.py`), and the
port imports nothing of it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .request import Request


@dataclass
class MixedBatchConfig:
    """Ref MixedBatchConfig ch08/mixed_batch.py:34-39."""

    max_batch_tokens: int = 2048
    max_prefill_tokens: int = 1024
    max_decode_batch: int = 64
    prefill_priority: float = 0.5


@dataclass
class MixedBatch:
    """Ref MixedBatch :20-31."""

    prefill_ids: list[str] = field(default_factory=list)
    decode_ids: list[str] = field(default_factory=list)
    num_prefill_tokens: int = 0

    @property
    def num_decode_tokens(self) -> int:
        return len(self.decode_ids)

    @property
    def total_tokens(self) -> int:
        return self.num_prefill_tokens + self.num_decode_tokens

    @property
    def prefill_fraction(self) -> float:
        """Ref :27-31."""
        return (self.num_prefill_tokens / self.total_tokens
                if self.total_tokens else 0.0)


class MixedBatchScheduler:
    def __init__(self, config: MixedBatchConfig | None = None):
        self.config = config or MixedBatchConfig()

    def build_batch(self, prefill_queue: list[Request],
                    decode_queue: list[Request]) -> MixedBatch:
        """Ref build_batch :60-110. Consumes admitted requests from the fronts
        of the queues (does not mutate them)."""
        cfg = self.config
        batch = MixedBatch()
        prefill_budget = min(int(cfg.max_batch_tokens * cfg.prefill_priority),
                             cfg.max_prefill_tokens)
        for req in prefill_queue:
            remaining = req.prompt_len - req.prefill_pos
            if remaining <= 0 or remaining > prefill_budget:
                continue
            batch.prefill_ids.append(req.request_id)
            batch.num_prefill_tokens += remaining
            prefill_budget -= remaining

        decode_budget = min(cfg.max_batch_tokens - batch.num_prefill_tokens,
                            cfg.max_decode_batch)
        for req in decode_queue[:max(0, decode_budget)]:
            batch.decode_ids.append(req.request_id)
        return batch
