"""Request lifecycle (ref ch07/continuous_batcher.py:6-45 Request/RequestState).

Extended with the abort path the reference defines but never exercises
(ABORTED state is set by Request.abort()/engine cancellation here) and with
sampling parameters so the engine can thread per-request sampling through.

A copy of physics_llm_inference_tpu/sched/request.py with its
imports redirected into the port: the original's package imports jax, so
it cannot load here.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field

from ..ops.sampling import SamplingParams


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"
    ABORTED = "aborted"


@dataclass
class Request:
    request_id: str
    prompt_tokens: list[int]
    max_new_tokens: int = 128
    priority: int = 0
    sampling: SamplingParams = field(default_factory=SamplingParams)
    state: RequestState = RequestState.WAITING
    output_tokens: list[int] = field(default_factory=list)
    arrival_time: float = field(default_factory=time.monotonic)
    start_time: float | None = None
    first_token_time: float | None = None
    finish_time: float | None = None
    finish_reason: str | None = None
    # progress of chunked prefill: tokens already prefilled
    prefill_pos: int = 0
    kv_request_id: str | None = None  # handle into the paged pool

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)

    @property
    def num_generated(self) -> int:
        return len(self.output_tokens)

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + self.num_generated

    @property
    def prefill_done(self) -> bool:
        return self.prefill_pos >= self.prompt_len

    def ttft(self) -> float | None:
        """Time to first token (ref :36-41)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def is_done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.ABORTED)

    def abort(self, reason: str = "aborted") -> None:
        if not self.is_done():
            self.state = RequestState.ABORTED
            self.finish_reason = reason
            self.finish_time = time.monotonic()

    def finish(self, reason: str = "length") -> None:
        self.state = RequestState.FINISHED
        self.finish_reason = reason
        self.finish_time = time.monotonic()
