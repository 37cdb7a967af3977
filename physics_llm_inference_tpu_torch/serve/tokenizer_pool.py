"""Tokenizer worker pool (ref ch10/tokenizer_pool.py:35-99).

N workers, round-robin dispatch under a lock; sync, batch
(ThreadPoolExecutor), and callback-async tokenize paths; per-worker balance
stats. The default tokenizer is the reference's dummy ord(c)%256 mapping
(ch10/tokenizer_pool.py:55-56) so the whole serving path runs model-free; a
real tokenizer (e.g. transformers) plugs in via the factory argument.

Host-side CPU work — tokenization never touches the device, and the pool keeps
it off the engine's scheduling thread.

A copy of physics_llm_inference_tpu/serve/tokenizer_pool.py: the original's
package imports jax (its serve/__init__.py imports the engine), so it cannot
load here.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable


class _DummyTokenizer:
    """Ref ch10/tokenizer_pool.py:55-56."""

    def encode(self, text: str) -> list[int]:
        return [ord(c) % 256 for c in text]

    def decode(self, ids: list[int]) -> str:
        return "".join(chr(i % 256) for i in ids)


class TokenizerPool:
    def __init__(self, num_workers: int = 4,
                 tokenizer_factory: Callable | None = None):
        factory = tokenizer_factory or _DummyTokenizer
        self.workers = [factory() for _ in range(num_workers)]
        self.counts = [0] * num_workers
        self._next = 0
        self._lock = threading.Lock()
        self._executor = ThreadPoolExecutor(max_workers=num_workers)

    def _pick(self) -> int:
        """Round-robin under lock (ref :58-62)."""
        with self._lock:
            i = self._next
            self._next = (self._next + 1) % len(self.workers)
            self.counts[i] += 1
            return i

    def tokenize(self, text: str) -> list[int]:
        """Sync path (ref :64-66). Adapts real tokenizer returns: HF
        `tokenizers` Encoding objects expose .ids; transformers encode()
        already returns a list."""
        out = self.workers[self._pick()].encode(text)
        ids = getattr(out, "ids", out)
        return list(ids)

    def detokenize(self, ids: list[int]) -> str:
        return self.workers[self._pick()].decode(list(ids))

    def tokenize_batch(self, texts: list[str]) -> list[list[int]]:
        """Parallel batch via futures (ref :68-75)."""
        futures = [self._executor.submit(self.tokenize, t) for t in texts]
        return [f.result() for f in futures]

    def tokenize_async(self, text: str, callback: Callable) -> None:
        """Callback-async path (ref :77-88)."""
        def run():
            callback(self.tokenize(text))
        self._executor.submit(run)

    def stats(self) -> dict:
        """Per-worker balance (ref :90-99)."""
        total = sum(self.counts)
        return {
            "num_workers": len(self.workers),
            "requests_per_worker": list(self.counts),
            "total_requests": total,
            "balance": (min(self.counts) / max(self.counts)
                        if max(self.counts) else 1.0),
        }
