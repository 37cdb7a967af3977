"""Paged KV cache: block pool + per-request block tables.

Capability parity: ref ch07/paged_memory.py (PagedKVCache L16-137, BlockTable
L6-13: free-set pool, allocate/extend/free, usage stats, allocation-failure
raise). Beyond the reference: allocation can *fail softly* via can_allocate so
the scheduler triggers preemption/eviction on memory pressure (the hook the
reference never wires up — SURVEY.md §5 failure detection), and blocks carry
refcounts so radix-prefix sharing can pin them.

TPU layout note: backing tensors are (num_blocks, block_size, Hkv, hd) per
layer-stack — block-major so a Pallas paged-attention kernel can DMA whole
blocks from HBM by table index. Bookkeeping is host-side Python (it runs once
per scheduler iteration, not per token — ref runs it on CPU too).

A copy of physics_llm_inference_tpu/runtime/paged_kv.py with its
imports redirected into the port: the original's package imports jax, so
it cannot load here.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BlockTable:
    """Per-request ordered list of physical block ids (ref ch07/paged_memory.py:6-13)."""

    request_id: str
    block_ids: list[int] = field(default_factory=list)
    num_tokens: int = 0

    def num_blocks(self) -> int:
        return len(self.block_ids)


class PagedKVCache:
    """Block-pool KV manager (ref ch07/paged_memory.py:16-137).

    Bookkeeping-only by default (like the reference on CPU, :38-51); the
    device arrays live in the runner and are indexed by the tables produced
    here.
    """

    def __init__(self, num_blocks: int, block_size: int, num_layers: int = 1,
                 num_kv_heads: int = 1, head_dim: int = 1,
                 dtype_bytes: int = 2):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.dtype_bytes = dtype_bytes
        self.free_blocks: set[int] = set(range(num_blocks))
        self.tables: dict[str, BlockTable] = {}
        # block id -> refcount (prefix-shared blocks are pinned by >1 request)
        self.ref_counts: dict[int, int] = {}

    # -- capacity queries (the soft-fail path the scheduler uses) ------------

    def blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def can_allocate(self, num_tokens: int,
                     shared_blocks: list[int] | None = None) -> bool:
        covered = len(shared_blocks or ()) * self.block_size
        return (self.blocks_needed(max(0, num_tokens - covered))
                <= len(self.free_blocks))

    # -- allocation (ref :53-98) ---------------------------------------------

    def allocate(self, request_id: str, num_tokens: int,
                 shared_blocks: list[int] | None = None) -> BlockTable:
        """Allocate ceil(tokens/block_size) blocks (ref allocate_blocks :53-74).

        `shared_blocks` (from a radix-prefix hit) are attached by reference —
        their refcount rises, no new blocks spent on them; only the tail
        beyond the shared prefix is newly allocated.
        """
        if request_id in self.tables:
            raise RuntimeError(f"request {request_id} already has blocks")
        shared_blocks = list(shared_blocks or [])
        shared_tokens = len(shared_blocks) * self.block_size
        fresh_needed = self.blocks_needed(max(0, num_tokens - shared_tokens))
        if fresh_needed > len(self.free_blocks):
            raise RuntimeError(
                f"out of KV blocks: need {fresh_needed}, "
                f"free {len(self.free_blocks)}")
        fresh = [self.free_blocks.pop() for _ in range(fresh_needed)]
        for b in shared_blocks:
            self.ref_counts[b] = self.ref_counts.get(b, 0) + 1
        for b in fresh:
            self.ref_counts[b] = 1
        table = BlockTable(request_id, shared_blocks + fresh, num_tokens)
        self.tables[request_id] = table
        return table

    def extend(self, request_id: str, new_tokens: int = 1) -> list[int]:
        """Grow a request by new_tokens, allocating blocks when it crosses a
        boundary (ref extend_blocks :76-98). Returns newly allocated ids."""
        table = self.tables[request_id]
        needed = self.blocks_needed(table.num_tokens + new_tokens)
        fresh: list[int] = []
        while table.num_blocks() < needed:
            if not self.free_blocks:
                raise RuntimeError("out of KV blocks on extend")
            b = self.free_blocks.pop()
            self.ref_counts[b] = 1
            table.block_ids.append(b)
            fresh.append(b)
        table.num_tokens += new_tokens
        return fresh

    def free(self, request_id: str) -> int:
        """Release a request's blocks (ref free_blocks_for_request :100-110);
        shared blocks survive until their refcount drains. Returns #freed."""
        table = self.tables.pop(request_id, None)
        if table is None:
            return 0
        freed = 0
        for b in table.block_ids:
            self.ref_counts[b] -= 1
            if self.ref_counts[b] == 0:
                del self.ref_counts[b]
                self.free_blocks.add(b)
                freed += 1
        return freed

    # -- external ownership (radix prefix cache pins blocks) ------------------

    def ref_blocks(self, block_ids) -> None:
        """Take an extra reference on blocks (e.g. the radix cache keeping a
        finished request's prefix alive for reuse)."""
        for b in block_ids:
            self.ref_counts[b] = self.ref_counts.get(b, 0) + 1
            self.free_blocks.discard(b)

    def release_blocks(self, block_ids) -> int:
        """Drop references taken with ref_blocks; returns #blocks freed."""
        freed = 0
        for b in block_ids:
            if b not in self.ref_counts:
                continue
            self.ref_counts[b] -= 1
            if self.ref_counts[b] == 0:
                del self.ref_counts[b]
                self.free_blocks.add(b)
                freed += 1
        return freed

    # -- stats (ref :115-137) -------------------------------------------------

    def block_bytes(self) -> int:
        return (2 * self.block_size * self.num_layers * self.num_kv_heads
                * self.head_dim * self.dtype_bytes)

    def stats(self) -> dict:
        used = self.num_blocks - len(self.free_blocks)
        return {
            "num_blocks": self.num_blocks,
            "used_blocks": used,
            "free_blocks": len(self.free_blocks),
            "utilization": used / self.num_blocks if self.num_blocks else 0.0,
            "active_requests": len(self.tables),
            "bytes_per_block": self.block_bytes(),
            "used_bytes": used * self.block_bytes(),
        }
