"""Policy-driven scheduler with token budgets and memory-pressure preemption.

Capability parity: ref ch07/scheduler.py (SchedulerConfig L11-16, policies
L70-76, token budget L78-102, SchedulerOutput L37-44, update L122-133,
preempt L135-139). Beyond the reference: preemption here is *triggered* — a
PagedKVCache is consulted during admission and, when the pool can't fit an
admitted request, the lowest-priority / youngest running request is preempted
and its blocks freed (the memory-pressure hook ref never wires, SURVEY.md §5).

A copy of physics_llm_inference_tpu/sched/scheduler.py with its
imports redirected into the port: the original's package imports jax, so
it cannot load here.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..runtime.paged_kv import PagedKVCache
from .request import Request, RequestState


class SchedulingPolicy(enum.Enum):
    FCFS = "fcfs"
    SHORTEST_FIRST = "shortest_first"
    PRIORITY = "priority"


@dataclass
class SchedulerConfig:
    max_batch_size: int = 32
    max_tokens_per_batch: int = 8192
    policy: SchedulingPolicy = SchedulingPolicy.FCFS
    # KV reservation at admission: "full" reserves prompt+max_new upfront
    # (no decode-time OOM, lower occupancy — the slot engine's policy);
    # "prompt" reserves the prompt only and grows block-by-block during
    # decode (vLLM-style paged policy; pairs with preemption on pressure).
    kv_reserve: str = "full"


@dataclass
class SchedulerOutput:
    """Ref SchedulerOutput ch07/scheduler.py:37-44."""

    prefill: list[Request] = field(default_factory=list)
    decode: list[Request] = field(default_factory=list)
    preempted: list[Request] = field(default_factory=list)
    num_prefill_tokens: int = 0
    num_decode_tokens: int = 0


class Scheduler:
    def __init__(self, config: SchedulerConfig | None = None,
                 kv_pool: PagedKVCache | None = None,
                 shared_blocks_fn=None):
        self.config = config or SchedulerConfig()
        self.kv_pool = kv_pool
        # optional hook: req -> list of prefix block ids already cached
        # (radix prefix reuse); attached by reference at allocation
        self.shared_blocks_fn = shared_blocks_fn
        self.waiting: list[Request] = []
        self.running: dict[str, Request] = {}
        self.num_finished = 0
        self.num_preempted = 0

    def add_request(self, req: Request) -> None:
        self.waiting.append(req)

    def _sort_waiting(self) -> None:
        """Policy sort (ref :70-76)."""
        p = self.config.policy
        if p == SchedulingPolicy.SHORTEST_FIRST:
            self.waiting.sort(key=lambda r: r.prompt_len)
        elif p == SchedulingPolicy.PRIORITY:
            self.waiting.sort(key=lambda r: -r.priority)
        # FCFS: arrival order preserved

    def _preempt_for(self, needed_tokens: int) -> list[Request]:
        """Memory-pressure preemption: park running requests (lowest priority,
        then most recently started) and free their blocks until the pool can
        fit `needed_tokens`. Returns preempted requests."""
        if self.kv_pool is None:
            return []
        victims: list[Request] = []
        candidates = sorted(self.running.values(),
                            key=lambda r: (r.priority, -(r.start_time or 0)))
        for victim in candidates:
            if self.kv_pool.can_allocate(needed_tokens):
                break
            self.kv_pool.free(victim.kv_request_id or victim.request_id)
            victim.state = RequestState.PREEMPTED
            victim.prefill_pos = 0  # its KV is gone; must re-prefill
            del self.running[victim.request_id]
            self.waiting.insert(0, victim)
            victims.append(victim)
            self.num_preempted += 1
        return victims

    def schedule(self) -> SchedulerOutput:
        """One iteration: sort → admit under budget (+ preempt on memory
        pressure) → emit prefill/decode sets (ref :82-120)."""
        out = SchedulerOutput()
        self._sort_waiting()

        budget = self.config.max_tokens_per_batch
        for req in self.running.values():
            out.decode.append(req)
            out.num_decode_tokens += 1
        budget -= out.num_decode_tokens

        for req in list(self.waiting):
            # self.running already includes this iteration's admissions
            if len(self.running) >= self.config.max_batch_size:
                break
            if req.prompt_len > budget:
                continue
            reserve = req.prompt_len + (
                req.max_new_tokens if self.config.kv_reserve == "full" else 1)
            shared = (self.shared_blocks_fn(req)
                      if self.shared_blocks_fn else None)
            if self.kv_pool is not None and not self.kv_pool.can_allocate(
                    reserve, shared):
                victims = self._preempt_for(reserve)
                out.preempted.extend(victims)
                # a victim may have been admitted EARLIER IN THIS CALL
                # (most-recently-started sorts first): its pool allocation
                # is gone, so it must leave this iteration's prefill set
                # too, or the engine would prefill into freed blocks
                # (KeyError under serving load, round 4)
                gone = {v.request_id for v in victims}
                if gone:
                    out.prefill = [r for r in out.prefill
                                   if r.request_id not in gone]
                if not self.kv_pool.can_allocate(reserve, shared):
                    continue
            if self.kv_pool is not None:
                self.kv_pool.allocate(req.request_id, reserve,
                                      shared_blocks=shared)
                req.kv_request_id = req.request_id
            self.waiting.remove(req)
            req.state = RequestState.RUNNING
            import time as _t
            req.start_time = _t.monotonic()
            self.running[req.request_id] = req
            out.prefill.append(req)
            out.num_prefill_tokens += req.prompt_len
            budget -= req.prompt_len
        return out

    def update(self, finished_ids: list[str],
               generated: dict[str, int] | None = None) -> None:
        """Record generated tokens and retire finished requests, freeing
        their KV blocks (ref update :122-133)."""
        for rid, tok in (generated or {}).items():
            if rid in self.running:
                self.running[rid].output_tokens.append(tok)
        for rid in finished_ids:
            req = self.running.pop(rid, None)
            if req is None:
                continue
            if not req.is_done():
                req.finish("length")
            if self.kv_pool is not None:
                self.kv_pool.free(req.kv_request_id or rid)
            self.num_finished += 1

    def stats(self) -> dict:
        """Ref get_stats :141-145."""
        s = {
            "waiting": len(self.waiting),
            "running": len(self.running),
            "finished": self.num_finished,
            "preempted": self.num_preempted,
        }
        if self.kv_pool is not None:
            s["kv"] = self.kv_pool.stats()
        return s
