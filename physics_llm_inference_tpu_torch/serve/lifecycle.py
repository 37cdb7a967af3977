"""The request lifecycle both serving engines share: intake into the
scheduler with the request's stream listeners, token notification, retire,
abort, streaming and waiting (counterparts: the same methods of
physics_llm_inference_tpu/serve/engine.py and serve/paged_engine.py, which
keep a copy each).

An engine that mixes this in calls `_init_lifecycle()`, holds a
`scheduler`, and defines `submit_request` and `step()`, which holds `_lock`
for a whole iteration. A stream listener is a list that each emitted token
is appended to; it is registered under the engine lock in the same critical
section that makes the request schedulable, so no step can emit a token
before the listener is there.

Each request's time is recorded as three consecutive spans
(utils/tracing.py): `request.queued` opens when `submit_request` is
called (before it waits for the engine lock), the engine calls
`_advance(r, "request.queued")` at its first admission and
`_advance(r, "request.first_token")` at its first token, and `_finish`
closes `request.decode`.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..sched.request import Request
from ..utils import tracing

# the span that follows each of a request's spans
_NEXT = {"request.queued": "request.first_token",
         "request.first_token": "request.decode"}


@dataclass
class GenerationRequest:
    """Ref GenerationRequest ch10/engine.py:19-30."""

    prompt_tokens: list[int]
    max_tokens: int = 128
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    stop_tokens: tuple[int, ...] = ()
    request_id: str | None = None


@dataclass
class GenerationResult:
    """Ref GenerationResult ch10/engine.py:33-43."""

    request_id: str
    tokens: list[int]
    finish_reason: str
    ttft_s: float | None
    total_s: float

    @property
    def tokens_per_s(self) -> float:
        return len(self.tokens) / self.total_s if self.total_s > 0 else 0.0


class RequestLifecycle:
    def _init_lifecycle(self) -> None:
        # RLock: abort_request holds it while _finish re-acquires
        self._lock = threading.RLock()
        self._result_cv = threading.Condition()
        self._next_id = 0
        self._results: dict[str, GenerationResult] = {}
        self._listeners: dict[str, list] = {}
        self._open: dict[str, tuple] = {}   # rid -> (open span, its start)
        self._total_requests = 0
        self._total_tokens = 0

    def _new_id(self, req: GenerationRequest) -> str:
        with self._lock:
            rid = req.request_id or f"req-{self._next_id}"
            self._next_id += 1
            self._total_requests += 1
        return rid

    def _enqueue(self, r: Request, listener: list | None,
                 submitted_ns: int) -> None:
        """Make `r` schedulable, its listeners registered first;
        `submitted_ns`: when its submit_request was called (tracing.now)."""
        with self._lock:
            self._listeners[r.request_id] = ([] if listener is None
                                             else [listener])
            if tracing.RECORDER.enabled:
                self._open[r.request_id] = ("request.queued", submitted_ns)
            self.scheduler.add_request(r)

    def _advance(self, r: Request, span: str) -> None:
        """End `r`'s span `span` now and open the next one; nothing when
        another span is open (a re-admission after a preemption keeps the
        first admission)."""
        opened = self._open.get(r.request_id)
        if opened is None or opened[0] != span:
            return
        t = tracing.now()
        tracing.record(span, opened[1], t, r.request_id)
        self._open[r.request_id] = (_NEXT[span], t)

    def _notify(self, r: Request, tok: int) -> None:
        for q in self._listeners.get(r.request_id, []):
            q.append(tok)

    def _finish(self, r: Request) -> None:
        opened = self._open.pop(r.request_id, None)
        if opened is not None:
            tracing.record(opened[0], opened[1], key=r.request_id,
                           attrs=(r.finish_reason, len(r.output_tokens)))
        total = (r.finish_time or time.monotonic()) - r.arrival_time
        self._results[r.request_id] = GenerationResult(
            request_id=r.request_id, tokens=list(r.output_tokens),
            finish_reason=r.finish_reason or "length",
            ttft_s=r.ttft(), total_s=total)
        with self._lock:
            self._total_tokens += len(r.output_tokens)
        with self._result_cv:
            self._result_cv.notify_all()

    def abort_request(self, request_id: str) -> bool:
        """Abort a waiting request at once, a running one at its next
        retire (ref defines ABORTED but never sets it)."""
        with self._lock:
            for r in self.scheduler.waiting:
                if r.request_id == request_id:
                    r.abort()
                    self.scheduler.waiting.remove(r)
                    self._finish(r)
                    return True
            r = self.scheduler.running.get(request_id)
            if r is not None:
                r.abort()
                return True
        return False

    def run_until_done(self, request_ids: list[str] | None = None,
                       max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if request_ids is not None and all(
                    rid in self._results for rid in request_ids):
                return
            if request_ids is None and not (self.scheduler.waiting
                                            or self.scheduler.running):
                return
            self.step()

    def generate(self, req: GenerationRequest) -> GenerationResult:
        """Blocking single-request API (ref generate ch10/engine.py:117-171).
        """
        rid = self.submit_request(req)
        self.run_until_done([rid])
        return self._results[rid]

    def generate_stream(self, req: GenerationRequest):
        """Yield tokens as generated (ref generate_stream :173-198)."""
        buf: list[int] = []
        rid = self.submit_request(req, listener=buf)
        sent = 0
        while rid not in self._results or sent < len(buf):
            if sent < len(buf):
                yield buf[sent]
                sent += 1
            else:
                self.step()
        self._listeners.pop(rid, None)

    def get_result(self, request_id: str) -> GenerationResult | None:
        return self._results.get(request_id)

    def wait_result(self, request_id: str, timeout: float | None = None):
        """Block until the request finishes (a condition-variable wait, not
        a poll, so waiting client threads take no interpreter time from the
        engine loop). Returns None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._result_cv:
            while request_id not in self._results:
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return None
                self._result_cv.wait(rem if rem is not None else 1.0)
        return self._results[request_id]
