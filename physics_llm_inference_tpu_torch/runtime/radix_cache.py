"""Radix prefix cache with refcounts and LRU eviction.

Capability parity: ref ch07/radix_cache.py (RadixNode L4-12, insert with node
splitting L21-70, match_prefix L72-103, hit-rate L105-117) — plus the two
things the reference explicitly lacks (its own comments, SURVEY.md §2.7):
real reference counting (lock/unlock around use) and LRU eviction integrated
with the block pool (evict returns the kv block ids to recycle).

Keys are token ids; each cached token maps 1:1 to a kv index (a slot or a
(block, offset) encoding — the cache is agnostic, it stores ints).

A copy of physics_llm_inference_tpu/runtime/radix_cache.py with its
imports redirected into the port: the original's package imports jax, so
it cannot load here.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field


@dataclass
class RadixNode:
    token_ids: list[int] = field(default_factory=list)
    kv_indices: list[int] = field(default_factory=list)
    children: dict[int, "RadixNode"] = field(default_factory=dict)
    parent: "RadixNode | None" = None
    ref_count: int = 0
    last_access: float = 0.0

    def is_leaf(self) -> bool:
        return not self.children


class RadixCache:
    """Token-level radix tree over cached KV prefixes."""

    def __init__(self, time_fn=time.monotonic):
        self.root = RadixNode()
        self._time = time_fn
        self._clock = itertools.count()  # tie-break for equal timestamps
        self._tick: dict[int, int] = {}
        self.hits = 0
        self.lookups = 0

    # -- core ops (ref :21-103) ----------------------------------------------

    def insert(self, token_ids: list[int], kv_indices: list[int]) -> int:
        """Insert a sequence; splits nodes at divergence (ref :21-70).
        Returns number of *new* tokens inserted (suffix beyond existing)."""
        assert len(token_ids) == len(kv_indices)
        node = self.root
        i = 0
        now = self._time()
        while i < len(token_ids):
            nxt = node.children.get(token_ids[i])
            if nxt is None:
                child = RadixNode(token_ids=list(token_ids[i:]),
                                  kv_indices=list(kv_indices[i:]),
                                  parent=node, last_access=now)
                self._touch(child)
                node.children[token_ids[i]] = child
                return len(token_ids) - i
            # walk the edge
            m = 0
            while (m < len(nxt.token_ids) and i + m < len(token_ids)
                   and nxt.token_ids[m] == token_ids[i + m]):
                m += 1
            if m < len(nxt.token_ids):
                # split edge at m (ref node splitting :40-58)
                tail = RadixNode(token_ids=nxt.token_ids[m:],
                                 kv_indices=nxt.kv_indices[m:],
                                 children=nxt.children, parent=nxt,
                                 ref_count=nxt.ref_count,
                                 last_access=nxt.last_access)
                for child in tail.children.values():
                    child.parent = tail
                nxt.token_ids = nxt.token_ids[:m]
                nxt.kv_indices = nxt.kv_indices[:m]
                nxt.children = {tail.token_ids[0]: tail}
            node = nxt
            self._touch(node)
            i += m
        return 0

    def match_prefix(self, token_ids: list[int],
                     lock: bool = False) -> tuple[int, list[int]]:
        """Longest cached prefix (ref :72-103). Returns (matched_len,
        kv_indices). With lock=True the matched path's refcounts are
        incremented — call unlock() with the same tokens when done."""
        self.lookups += 1
        node = self.root
        i = 0
        kv: list[int] = []
        path: list[RadixNode] = []
        while i < len(token_ids):
            nxt = node.children.get(token_ids[i])
            if nxt is None:
                break
            m = 0
            while (m < len(nxt.token_ids) and i + m < len(token_ids)
                   and nxt.token_ids[m] == token_ids[i + m]):
                m += 1
            kv.extend(nxt.kv_indices[:m])
            i += m
            if m < len(nxt.token_ids):
                break
            node = nxt
            path.append(node)
            self._touch(node)
        if i > 0:
            self.hits += 1
        if lock:
            for n in path:
                n.ref_count += 1
        return i, kv

    def unlock(self, token_ids: list[int]) -> None:
        """Drop the refcounts taken by match_prefix(lock=True)."""
        node = self.root
        i = 0
        while i < len(token_ids):
            nxt = node.children.get(token_ids[i])
            if nxt is None:
                return
            m = 0
            while (m < len(nxt.token_ids) and i + m < len(token_ids)
                   and nxt.token_ids[m] == token_ids[i + m]):
                m += 1
            if m < len(nxt.token_ids):
                return
            i += m
            node = nxt
            node.ref_count = max(0, node.ref_count - 1)

    # -- eviction (beyond the reference) --------------------------------------

    def _touch(self, node: RadixNode) -> None:
        node.last_access = self._time()
        self._tick[id(node)] = next(self._clock)

    def evict(self, num_tokens: int) -> list[int]:
        """Evict least-recently-used *unreferenced leaves* until >= num_tokens
        cached tokens are released. Returns the freed kv indices (for the
        block pool to recycle)."""
        freed: list[int] = []
        while len(freed) < num_tokens:
            victim = None
            for node in self._iter_leaves(self.root):
                if node is self.root or node.ref_count > 0:
                    continue
                key = (node.last_access, self._tick.get(id(node), 0))
                if victim is None or key < (victim.last_access,
                                            self._tick.get(id(victim), 0)):
                    victim = node
            if victim is None:
                break
            freed.extend(victim.kv_indices)
            parent = victim.parent
            if parent is not None:
                parent.children.pop(victim.token_ids[0], None)
            self._tick.pop(id(victim), None)
        return freed

    def _iter_leaves(self, node: RadixNode):
        if node.is_leaf() and node is not self.root:
            yield node
        for c in node.children.values():
            yield from self._iter_leaves(c)

    # -- stats (ref :105-117) -------------------------------------------------

    def total_cached_tokens(self) -> int:
        def walk(n):
            return len(n.token_ids) + sum(walk(c) for c in n.children.values())
        return walk(self.root)

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def stats(self) -> dict:
        return {"cached_tokens": self.total_cached_tokens(),
                "lookups": self.lookups, "hits": self.hits,
                "hit_rate": self.hit_rate()}
