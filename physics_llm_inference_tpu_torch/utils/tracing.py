"""Spans of the serving and offline paths, always recorded, in a ring of
fixed size.

A span is a name, a start and an end on `time.time_ns()`'s clock (the host
clock a `torch.profiler` trace can be mapped onto), the key of what caused
it (an engine step's number, or a request's id) and small attributes. The
paged engine (serve/paged_engine.py) and the request lifecycle
(serve/lifecycle.py) record:

- `engine.step`, one per iteration of `PagedInferenceEngine.step`, keyed by
  the engine's step number, and inside it, keyed the same way:
  `schedule` (radix eviction relief, `Scheduler.schedule`, preemption
  bookkeeping, admission, picking the prefill chunks); per prompt bucket
  `prefill.stage` (the input arrays and their copy into the step's static
  buffers), `prefill.launch` (the step's launch; attributes: the bucket's
  `dispatch_trace` entry) and `prefill.results` (sampling the first tokens,
  reading them back, handing them to the listeners); `decode.prepare` (KV
  growth, eviction or preemption, the horizon, table sync, staging),
  `decode.launch` (attributes: the `dispatch_trace` entry followed by the
  decoding rows' lengths, in the entry's row order), `decode.results`
  (waiting for the tokens to reach the host, handing them out) and
  `retire` (finish, radix commit, `Scheduler.update`);
- per request, keyed by its id: `request.queued` (submit to its first
  admission), `request.first_token` (first admission to its first token)
  and `request.decode` (first token to finish; attributes: the finish
  reason and the tokens generated). A re-admission after a preemption
  opens no new span. A request that finishes early (an abort) closes the
  span it is in, with the same attributes;
- per `runtime/generate.cached_generate` call, keyed by the call's number
  in the process: `generate.prefill` and `generate.decode`, each ending
  after its phase's synchronization (attributes: the rows, the prompt
  bucket, the new tokens, the cache's kind and its bytes a token over
  every layer); and inside a prefill, per MoE layer and row slice on the
  dropless path (`models/moe._dropless`), `moe.prefill_route`
  (attributes: the largest and the mean rows an expert, the experts, the
  routed pairs), counted on the host before the expert products. Nothing
  is recorded inside a captured step.

Recording costs two clock reads and an append to a bounded deque, under a
lock; nothing waits for the device. `RECORDER.enabled = False` records
nothing, and the paged engine then takes no time stamps. The ring holds
`CAPACITY` spans. Sizing: the serving benchmark's Mistral-7B chat cell
recorded 8,255-8,527 spans from its warm-up burst to the close (58-59 s at
142-145 a second: ~9 an engine step at ~11.3 steps a second, and 3 a
request) on an H100, so 16,384 spans hold that run about twice over. Full
of that mix (a decode launch's attributes carry 64 rows and 64 lengths)
the ring holds 7.5 MB, ~460 bytes a span, by tracemalloc; it grows no
further.

Step numbers come from one counter for the process, so the spans of two
engines in one process never share a step's key. A request's spans are
keyed by its id, which is unique within its engine only.

Reading it from a running server: the ring lives in the server's process,
so start the OpenAI-compatible server (serve/http_server.py) from an
interpreter that stays open beside it::

    python -i -c "import threading; from physics_llm_inference_tpu_torch \
import cli; threading.Thread(target=cli.main, args=(['serve', '--config', \
'llama7b', '--int8', '--paged'],), daemon=True).start()"

Where a slow request's time went is its three `request.*` spans; the
`engine.step` spans that overlap them, and their children, say what the
engine was doing meanwhile::

    from physics_llm_inference_tpu_torch.utils import tracing
    snap = tracing.RECORDER.snapshot()
    mine = [s for s in snap.spans if s.key == "req-1234"]
    for s in mine:
        print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms", s.attrs)

`snap.overwritten` counts the spans the ring has dropped; every span that
ended after `snap.complete_from_ns` is still held.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import NamedTuple

CAPACITY = 1 << 14

now = time.time_ns


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    key: object             # an engine step's number or a request's id
    attrs: object = None


class Snapshot(NamedTuple):
    spans: list             # in the order they were recorded
    overwritten: int        # spans the ring dropped
    complete_from_ns: int   # every span that ended after this is held


class Recorder:
    """The newest `capacity` spans."""

    def __init__(self, capacity: int = CAPACITY):
        self.enabled = True
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)   # of Span's fields
        self._n = 0
        self._lost_end = 0

    def record(self, name: str, start_ns: int, end_ns: int | None = None,
               key=None, attrs=None) -> None:
        """Record a span that ended at `end_ns` (now when None)."""
        if not self.enabled:
            return
        if end_ns is None:
            end_ns = now()
        with self._lock:
            d = self._spans
            if len(d) == d.maxlen:
                self._lost_end = max(self._lost_end, d[0][2])
            d.append((name, start_ns, end_ns, key, attrs))
            self._n += 1

    def snapshot(self) -> Snapshot:
        """The spans the ring holds, oldest first."""
        with self._lock:
            held, n, lost_end = list(self._spans), self._n, self._lost_end
        return Snapshot(list(map(Span._make, held)), n - len(held), lost_end)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._n = self._lost_end = 0


RECORDER = Recorder()
record = RECORDER.record
