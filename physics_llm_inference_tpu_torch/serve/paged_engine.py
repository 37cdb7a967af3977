"""Paged inference engine: continuous batching over block-table KV with
radix prefix reuse (counterpart: physics_llm_inference_tpu/serve/
paged_engine.py, BASELINE config 3).

- KV lives in per-layer block POOLS, plain (L, num_blocks+1, bs, Hkv, hd) or
  the merged INT8 QuantKV pools (L, num_blocks+1, 2, bs, Hkv·hd) /
  (L, num_blocks+1, 2, Hkv, bs); requests own scattered blocks through
  PagedKVCache tables; the +1 is the trash block that absorbs the writes of
  inactive batch rows.
- Admission reserves the prompt only; decode grows block by block, and pool
  pressure is relieved by radix eviction first, then preemption.
- A radix prefix cache (C++-backed when the library loads) is consulted on
  admission: cached full prompt blocks attach by reference and prefill
  starts at the first uncached block.

The host logic of `step()` is the JAX engine's, line for line, so the same
request stream gives the same `dispatch_trace`. What differs: the pools are
torch tensors on the device of the parameters, updated in place by the
model functions; a `torch.Generator` stands where the JAX engine splits a
PRNG key. Dispatch steps are cached as the JAX engine caches its jitted
steps: prefill chunks in a `StepCache` keyed by the prompt bucket
(`stats()["prefill_compile"]`), each entry holding one step per padded row
count, and decode horizons in `_decode_fns` keyed by (horizon, filtered).
On CUDA each step is a captured CUDA graph over static input buffers, which
the host fills through pinned staging buffers, and all of an engine's
graphs share one memory pool; `warmup()` captures every decode horizon and
each prefill bucket at one row. On the CPU the steps run eagerly. On CUDA
the default INT8 geometry decodes through K8 (the fused paged kernel); the
per-op routes run K6 (INT8 pools) or K7 (bf16 pools). Not ported yet: TP
serving (`mesh` raises) and the streaming, abort and blocking-wait calls
the HTTP server uses (`generate_stream`, `abort_request`, `wait_result`;
ROADMAP Queue A, slot serving and the HTTP front end).
"""
from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.fused_decode import fused_paged_decode_ok
from ..models.config import ModelConfig
from ..models.paged_transformer import (paged_decode_scan_impl,
                                        paged_prefill_chunk_impl)
from ..models.transformer import QuantKV
from ..native import make_radix_cache
from ..ops.sampling import SamplingParams, sample_token
from ..runtime.paged_kv import PagedKVCache
from ..runtime.step_cache import (CapturedStep, StagedInputs, StepCache,
                                  bucket_for)
from ..sched.request import Request, RequestState
from ..sched.scheduler import Scheduler, SchedulerConfig, SchedulingPolicy
from .engine import GenerationRequest, GenerationResult


@dataclass
class PagedEngineConfig:
    """Defaults sized for throughput serving: a 64-deep decode batch with
    1024-token capacity per request as 2 blocks of 512 (the reference's
    production geometry). Tests override with smaller geometries."""

    num_blocks: int = 64 * 2 + 32
    block_size: int = 512
    max_batch: int = 64                 # decode width
    max_blocks_per_request: int = 2
    prompt_buckets: tuple = (16, 32, 64, 128, 256, 512, 1024)
    max_prefill_chunk: int = 512
    policy: SchedulingPolicy = SchedulingPolicy.FCFS
    enable_radix: bool = True
    kv_dtype: str | None = None
    # Mixed prefill/decode iterations: per-iteration prefill token budget;
    # None -> max_prefill_chunk.
    prefill_tokens_per_iter: int | None = None
    # Multi-step scheduling: decode up to this many tokens per dispatch,
    # sampling included; decode_horizon_pressured while requests wait.
    decode_horizon: int = 8
    decode_horizon_pressured: int = 2

    @classmethod
    def for_fused(cls, max_batch: int = 64, max_seq_len: int = 1024,
                  spare_blocks: int = 16, **kw) -> "PagedEngineConfig":
        """Geometry that passes the fused paged gate: blocks a multiple of
        128 tokens (rounded up for short contexts), batch a multiple of 8."""
        bs = max(128, min(512, -(-max_seq_len // 2 // 128) * 128))
        mb = (max_seq_len + bs - 1) // bs
        return cls(block_size=bs, max_blocks_per_request=mb,
                   max_batch=max_batch,
                   num_blocks=max_batch * mb + spare_blocks, **kw)


class PagedInferenceEngine:
    def __init__(self, params, model_cfg: ModelConfig,
                 config: PagedEngineConfig | None = None, mesh=None):
        """params: the port's parameter dict; the pools are made on the
        device of params["embed"]. mesh: TP serving is not ported."""
        if mesh is not None:
            raise NotImplementedError("tensor-parallel paged serving is not "
                                      "ported yet (ROADMAP Queue A)")
        self.cfg = model_cfg
        self.config = c = config or PagedEngineConfig()
        self.params = params
        self.device = dev = params["embed"].device

        kv_dtype = getattr(torch, c.kv_dtype or model_cfg.dtype)
        nl, hkv, hd = (model_cfg.num_layers, model_cfg.num_kv_heads,
                       model_cfg.head_dim)
        if kv_dtype == torch.int8:
            # merged pools: each block's K page (axis-2 index 0) and V page
            # (index 1) side by side; self._k carries the pair, self._v is
            # None
            self._k = QuantKV(
                q=torch.zeros((nl, c.num_blocks + 1, 2, c.block_size,
                               hkv * hd), dtype=torch.int8, device=dev),
                s=torch.zeros((nl, c.num_blocks + 1, 2, hkv, c.block_size),
                              dtype=torch.float32, device=dev))
            self._v = None
        else:
            shape = (nl, c.num_blocks + 1, c.block_size, hkv, hd)
            self._k = torch.zeros(shape, dtype=kv_dtype, device=dev)
            self._v = torch.zeros(shape, dtype=kv_dtype, device=dev)
        self._kv_quantized = kv_dtype == torch.int8
        self._trash = c.num_blocks  # physical row for dead writes

        # the reference's line about the fused gate, where the gate is read:
        # on the accelerator
        if self._kv_quantized and dev.type == "cuda":
            if fused_paged_decode_ok(model_cfg, c.max_batch,
                                     c.max_blocks_per_request, c.block_size,
                                     NB=c.num_blocks + 1):
                print(f"[paged-engine] fused paged decode ON: batch="
                      f"{c.max_batch}, capacity="
                      f"{c.max_blocks_per_request * c.block_size} tokens "
                      f"({c.max_blocks_per_request}x{c.block_size} blocks)",
                      file=sys.stderr)
            else:
                print(f"[paged-engine] fused paged decode DISABLED for "
                      f"(batch={c.max_batch}, "
                      f"blocks/req={c.max_blocks_per_request}, "
                      f"block_size={c.block_size}, "
                      f"hidden={model_cfg.hidden_dim}, "
                      f"head_dim={model_cfg.head_dim}): the per-op paged "
                      f"path runs. The gate needs block_size % 128 == 0, "
                      f"batch % 8 == 0, hidden_dim/head_dim % 128 == 0 and "
                      f"a dense FFN (kernels/fused_decode."
                      f"fused_paged_decode_ok); see "
                      f"PagedEngineConfig.for_fused().", file=sys.stderr)

        self.pool = PagedKVCache(num_blocks=c.num_blocks,
                                 block_size=c.block_size,
                                 num_layers=model_cfg.num_layers,
                                 num_kv_heads=model_cfg.num_kv_heads,
                                 head_dim=model_cfg.head_dim)
        self.radix = make_radix_cache() if c.enable_radix else None
        self._radix_owned: dict[int, int] = {}  # block -> cached-token count
        self._matched: dict[str, int] = {}      # rid -> matched prefix len

        self.scheduler = Scheduler(
            SchedulerConfig(max_batch_size=c.max_batch,
                            max_tokens_per_batch=c.num_blocks * c.block_size,
                            policy=c.policy, kv_reserve="prompt"),
            kv_pool=self.pool,
            shared_blocks_fn=self._shared_blocks_for)

        self._row_of: dict[str, int] = {}
        self._prefilling: list = []  # admitted, prefill_pos < prompt_len
        self._tables = np.full((c.max_batch, c.max_blocks_per_request),
                               self._trash, dtype=np.int32)
        self._lengths = np.zeros(c.max_batch, dtype=np.int32)
        self._active = np.zeros(c.max_batch, dtype=bool)

        self._lock = threading.RLock()
        self._next_id = 0
        gen_dev = dev if dev.type == "cuda" else "cpu"
        self._rng = torch.Generator(device=gen_dev).manual_seed(0)
        self._results: dict[str, GenerationResult] = {}
        self._total_requests = 0
        self._total_tokens = 0
        self._radix_hit_tokens = 0
        # the graphs of this engine share one memory pool
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if dev.type == "cuda" else None)
        self._prefill_cache = StepCache(self._make_prefill)
        # (kind, bucket or horizon, ...) of every dispatch when a list
        self.dispatch_trace: list | None = None
        self._decode_fns: dict[tuple, tuple] = {}

    def _dev(self, a) -> torch.Tensor:
        """A host array as a fresh tensor on the engine's device."""
        return torch.tensor(np.asarray(a), device=self.device)

    # -------------------------------------------------------------- radix

    def _shared_blocks_for(self, r: Request) -> list[int]:
        """Scheduler hook: full blocks of the longest cached prefix."""
        if self.radix is None:
            return []
        bs = self.config.block_size
        matched, kv_idx = self.radix.match_prefix(r.prompt_tokens)
        # keep at least one prompt token for prefill (need logits to sample)
        matched = min(matched, r.prompt_len - 1)
        matched_blocks = matched // bs
        self._matched[r.request_id] = matched_blocks * bs
        shared = [kv_idx[i] // bs for i in range(0, matched_blocks * bs, bs)]
        # hits are counted once, when the admitted request's prefill
        # actually skips the matched prefix (_step_locked): this hook also
        # runs for the admission starvation-relief probe
        return shared

    def _radix_commit(self, r: Request) -> None:
        """On retirement: publish the prompt's KV into the radix cache and
        pin its blocks in the pool until eviction."""
        if self.radix is None:
            return
        table = self.pool.tables.get(r.kv_request_id or r.request_id)
        if table is None:
            return
        bs = self.config.block_size
        full = (r.prompt_len // bs) * bs
        if full == 0:
            return
        kv_idx = [table.block_ids[p // bs] * bs + p % bs for p in range(full)]
        inserted = self.radix.insert(r.prompt_tokens[:full], kv_idx)
        # pin every block that now holds cached tokens
        for p in range(full - inserted, full):
            b = kv_idx[p] // bs
            self._radix_owned[b] = self._radix_owned.get(b, 0) + 1
            if self._radix_owned[b] == 1:
                self.pool.ref_blocks([b])

    def _radix_evict(self, num_tokens: int) -> int:
        """Release LRU cached prefixes until num_tokens are freed (or dry)."""
        if self.radix is None:
            return 0
        freed_idx = self.radix.evict(num_tokens)
        bs = self.config.block_size
        released = 0
        for idx in freed_idx:
            b = idx // bs
            if b in self._radix_owned:
                self._radix_owned[b] -= 1
                if self._radix_owned[b] == 0:
                    del self._radix_owned[b]
                    released += self.pool.release_blocks([b])
        return released

    # ------------------------------------------------------------ dispatch

    def _step(self, fn, generators=(), **buffers):
        """A dispatch step over static input buffers: (inputs, step), the
        step captured on CUDA, `fn` itself on the CPU. The buffers' initial
        values must make `fn`'s writes harmless (tables on the trash
        block), since the capture's warm-up runs it on them."""
        inputs = StagedInputs(self.device, **buffers)

        def run():
            return fn(**inputs.buffers)

        if self.device.type != "cuda":
            return inputs, run
        return inputs, CapturedStep(run, self.device, self._graph_pool,
                                    generators)

    def _buf(self, *shape, fill=0, dtype=torch.int32) -> torch.Tensor:
        return torch.full(shape, fill, dtype=dtype, device=self.device)

    def _make_prefill(self, cb: int):
        """The prefill chunk steps of bucket `cb`: one per padded row count,
        made at its first use, as jit traces one per shape."""
        steps: dict[int, tuple] = {}
        mb, buf = self.config.max_blocks_per_request, self._buf

        def fn(ids, tables, starts, nval):
            logits, self._k, self._v = paged_prefill_chunk_impl(
                self.params, ids, self._k, self._v, tables, starts, nval,
                self.cfg)
            return logits

        def prefill(ids, tables, starts, nval):
            rb = ids.shape[0]
            if rb not in steps:
                steps[rb] = self._step(
                    fn, ids=buf(rb, cb), tables=buf(rb, mb, fill=self._trash),
                    starts=buf(rb), nval=buf(rb))
            inputs, step = steps[rb]
            inputs.load(ids=ids, tables=tables, starts=starts, nval=nval)
            return step()

        return prefill

    def _prefill(self, ids, tables, starts, nval):
        return self._prefill_cache.get(ids.shape[1])(ids, tables, starts,
                                                     nval)

    def _decode_for(self, horizon: int, filtered: bool):
        """The multi-step decode of this horizon; filtered=False is the
        variant without top-k/top-p (no per-step vocab sort)."""
        key = (horizon, filtered)
        if key not in self._decode_fns:
            c, buf = self.config, self._buf

            def fn(tokens, tables, lengths, temps, top_ks, top_ps):
                toks, self._k, self._v = paged_decode_scan_impl(
                    self.params, tokens, self._k, self._v, tables, lengths,
                    self._rng, temps, top_ps, self.cfg, horizon=horizon,
                    top_ks=top_ks, filtered=filtered)
                return toks

            self._decode_fns[key] = self._step(
                fn, (self._rng,), tokens=buf(c.max_batch),
                tables=buf(c.max_batch, c.max_blocks_per_request,
                           fill=self._trash),
                lengths=buf(c.max_batch),
                temps=buf(c.max_batch, fill=1, dtype=torch.float32),
                top_ks=buf(c.max_batch),
                top_ps=buf(c.max_batch, fill=1, dtype=torch.float32))
        return self._decode_fns[key]

    def _decode(self, horizon: int, filtered: bool, tokens, tables, temps,
                top_ks, top_ps) -> np.ndarray:
        inputs, step = self._decode_for(horizon, filtered)
        inputs.load(tokens=tokens, tables=tables, lengths=self._lengths,
                    temps=temps, top_ks=top_ks, top_ps=top_ps)
        return step().cpu().numpy()

    # ------------------------------------------------------------ requests

    def submit_request(self, req: GenerationRequest) -> str:
        with self._lock:
            rid = req.request_id or f"req-{self._next_id}"
            self._next_id += 1
            self._total_requests += 1
        cap = self.config.max_blocks_per_request * self.config.block_size
        if len(req.prompt_tokens) + req.max_tokens > cap:
            raise ValueError(
                f"prompt+max_tokens exceeds per-request KV capacity {cap}")
        r = Request(
            request_id=rid,
            prompt_tokens=list(req.prompt_tokens),
            max_new_tokens=req.max_tokens,
            sampling=SamplingParams(temperature=req.temperature,
                                    top_k=req.top_k, top_p=req.top_p,
                                    stop_tokens=tuple(req.stop_tokens)),
        )
        with self._lock:
            self.scheduler.add_request(r)
        return rid

    def warmup(self, buckets=None) -> float:
        """Make every power-of-two decode horizon up to decode_horizon and
        every prefill bucket at one row (on CUDA: capture them) and run each
        once against the trash block. Returns the seconds it took."""
        t0 = time.monotonic()
        c = self.config
        horizons = {1}
        hh = 1
        while hh * 2 <= c.decode_horizon:
            hh *= 2
            horizons.add(hh)
        for h in sorted(horizons):
            self._decode(h, False, np.zeros(c.max_batch, np.int32),
                         self._tables, np.ones(c.max_batch, np.float32),
                         np.zeros(c.max_batch, np.int32),
                         np.ones(c.max_batch, np.float32))
        trash_table = np.full((1, c.max_blocks_per_request), self._trash,
                              np.int32)
        for cb in (buckets or c.prompt_buckets):
            self._prefill(np.zeros((1, cb), np.int32), trash_table,
                          np.zeros(1, np.int32), np.ones(1, np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.monotonic() - t0

    def _sync_table_row(self, row: int, rid: str) -> None:
        tbl = self.pool.tables[rid].block_ids
        self._tables[row, :] = self._trash
        self._tables[row, :len(tbl)] = tbl

    # ---------------------------------------------------------------- step

    def step(self) -> dict[str, list[int]]:
        # one iteration under the engine lock: concurrent callers would race
        # the scheduler; RLock, so _finish can re-acquire
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> dict[str, list[int]]:
        # admission starvation relief: when the pool can't fit the next
        # waiting request, reclaim radix-cached prefixes first (LRU) —
        # eviction-before-preemption order
        if self.scheduler.waiting and self.radix is not None:
            head = self.scheduler.waiting[0]
            shared = self._shared_blocks_for(head)
            self._matched.pop(head.request_id, None)
            if not self.pool.can_allocate(head.prompt_len + 1, shared):
                self._radix_evict(head.prompt_len + 1)

        out = self.scheduler.schedule()
        emitted: dict[str, list[int]] = {}

        for r in out.preempted:
            row = self._row_of.pop(r.request_id, None)
            if row is not None:
                self._active[row] = False
            r.output_tokens.clear()
            self._matched.pop(r.request_id, None)

        # ---- prefill admitted requests (chunked; radix-matched prefix skipped)
        for r in out.prefill:
            # occupancy = _row_of (not _active: a row is claimed at
            # admission but only activates when its chunked prefill is done)
            used = set(self._row_of.values())
            row = next(i for i in range(self.config.max_batch)
                       if i not in used)
            self._row_of[r.request_id] = row
            r.start_time = r.start_time or time.monotonic()
            if r.prefill_pos == 0:
                r.prefill_pos = self._matched.pop(r.request_id, 0)
                # radix hits counted where they save work: these prefix
                # tokens are never prefilled
                self._radix_hit_tokens += r.prefill_pos
            self._prefilling.append(r)
        budget = (self.config.prefill_tokens_per_iter
                  or self.config.max_prefill_chunk)
        # batched prefill: one chunk per request per iteration, all
        # same-bucket chunks in one (R, cb) dispatch, one batched sample
        still_prefilling = []
        torun = []                            # (r, row, pos, n)
        for r in self._prefilling:
            row = self._row_of.get(r.request_id)
            if row is None or r.is_done():    # preempted/aborted meanwhile
                continue
            if (r.kv_request_id or r.request_id) not in self.pool.tables:
                # pool allocation revoked (preempted back to waiting after
                # admission) — it re-enters via a future schedule()
                self._row_of.pop(r.request_id, None)
                self._active[row] = False
                continue
            if budget <= 0:
                still_prefilling.append(r)
                continue
            n = min(r.prompt_len - r.prefill_pos,
                    self.config.max_prefill_chunk)
            torun.append((r, row, r.prefill_pos, n))
            budget -= n
        by_cb: dict[int, list] = {}
        for item in torun:
            cb = bucket_for(item[3], self.config.prompt_buckets)
            by_cb.setdefault(cb, []).append(item)
        for cb, items in sorted(by_cb.items()):
            rb = 1                            # pad R to a power of two, as
            while rb < len(items):            # the reference bounds its
                rb *= 2                       # compiled batch shapes
            ids = np.zeros((rb, cb), dtype=np.int32)
            tables = np.full((rb, self.config.max_blocks_per_request),
                             self._trash, dtype=np.int32)
            starts = np.zeros((rb,), dtype=np.int32)
            nval = np.zeros((rb,), dtype=np.int32)
            for j, (r, row, pos, n) in enumerate(items):
                self._sync_table_row(row, r.request_id)
                ids[j, :n] = r.prompt_tokens[pos:pos + n]
                tables[j] = self._tables[row]
                starts[j] = pos
                nval[j] = n
            if self.dispatch_trace is not None:
                self.dispatch_trace.append(
                    ("prefill", cb, tuple(it[1] for it in items),
                     tuple(it[2] for it in items), tuple(nval.tolist())))
            logits = self._prefill(ids, tables, starts, nval)
            done = []                          # (j, r, row)
            for j, (r, row, pos, n) in enumerate(items):
                r.prefill_pos = pos + n
                if r.prefill_pos < r.prompt_len:
                    still_prefilling.append(r)
                else:
                    done.append((j, r, row))
            if not done:
                continue
            idx = self._dev([j for j, _, _ in done])
            toks = sample_token(
                logits[idx], self._rng,
                temperature=self._dev(np.asarray(
                    [r.sampling.temperature for _, r, _ in done],
                    np.float32)),
                top_k=self._dev(np.asarray(
                    [r.sampling.top_k for _, r, _ in done], np.int32)),
                top_p=self._dev(np.asarray(
                    [r.sampling.top_p for _, r, _ in done], np.float32)))
            for (j, r, row), tok_i in zip(done, toks.cpu().tolist()):
                self._lengths[row] = r.prompt_len
                self._active[row] = True
                r.first_token_time = time.monotonic()
                r.output_tokens.append(tok_i)
                emitted.setdefault(r.request_id, []).append(tok_i)
        self._prefilling = still_prefilling

        # ---- grow KV for decoding requests; relieve pressure if needed
        # horizon: decode_horizon_pressured while requests wait, the full
        # decode_horizon when the queue is empty, bounded by table headroom
        c = self.config
        pressured = bool(self.scheduler.waiting or self._prefilling)
        target = (min(c.decode_horizon, c.decode_horizon_pressured)
                  if pressured else c.decode_horizon)
        h = 1
        if target > 1:
            cap = c.max_blocks_per_request * c.block_size
            lens = self._lengths[self._active]
            room = cap - 1 - (int(lens.max()) if lens.size else 0)
            while h * 2 <= min(target, max(1, room)):
                h *= 2
        candidates = []
        for r in out.decode:
            if (r.request_id not in self._row_of or r.is_done()
                    or not r.output_tokens):  # mid-prefill: not decoding yet
                continue
            rid = r.kv_request_id or r.request_id
            row = self._row_of[r.request_id]
            # extend only to what this request can still emit
            remaining = max(1, r.max_new_tokens - len(r.output_tokens))
            needed = int(self._lengths[row]) + min(h, remaining)
            tbl = self.pool.tables[rid]
            if self.pool.blocks_needed(needed) > tbl.num_blocks():
                if not self.pool.free_blocks:
                    self._radix_evict(self.config.block_size)
                if not self.pool.free_blocks:
                    # preempt someone else (never self) — or skip this step
                    victims = self.scheduler._preempt_for(
                        self.config.block_size)
                    for v in victims:
                        vrow = self._row_of.pop(v.request_id, None)
                        if vrow is not None:
                            self._active[vrow] = False
                        v.output_tokens.clear()
                if not self.pool.free_blocks:
                    continue  # still full: request waits this iteration
            candidates.append((r, rid, row))

        # demote the horizon BEFORE any extend: every decode row shares one
        # dispatch, and extend() advances table.num_tokens
        def _fresh_demand(hh: int) -> int:
            return sum(
                max(0, self.pool.blocks_needed(
                    self.pool.tables[rid].num_tokens + hh)
                    - self.pool.tables[rid].num_blocks())
                for _, rid, _ in candidates)

        while h > 1 and _fresh_demand(h) > len(self.pool.free_blocks):
            h //= 2

        decode_reqs = []
        for r, rid, row in candidates:
            try:
                fresh = self.pool.extend(rid, h)
            except RuntimeError:
                continue  # pool exhausted mid-pass: waits this iteration
            if fresh:
                self._sync_table_row(row, rid)
            decode_reqs.append(r)

        # ---- one paged decode dispatch for the whole batch
        if decode_reqs:
            tokens = np.zeros(self.config.max_batch, dtype=np.int32)
            temps = np.ones(self.config.max_batch, dtype=np.float32)
            top_ks = np.zeros(self.config.max_batch, dtype=np.int32)
            top_ps = np.ones(self.config.max_batch, dtype=np.float32)
            for r in decode_reqs:
                row = self._row_of[r.request_id]
                tokens[row] = r.output_tokens[-1]
                temps[row] = r.sampling.temperature
                top_ks[row] = r.sampling.top_k
                top_ps[row] = r.sampling.top_p
            filtered = bool((top_ks > 0).any() or (top_ps < 1.0).any())
            if self.dispatch_trace is not None:
                self.dispatch_trace.append(
                    ("decode", h, filtered,
                     tuple(int(self._row_of[r.request_id])
                           for r in decode_reqs)))
            # the decode writes K/V through every row's table: route
            # MID-PREFILL rows (inactive, but their tables point at blocks
            # holding prefilled KV) to the trash block
            tables = self._tables
            if self._prefilling:
                tables = self._tables.copy()
                for pr in self._prefilling:
                    prow = self._row_of.get(pr.request_id)
                    if prow is not None:
                        tables[prow, :] = self._trash
            toks = self._decode(h, filtered, tokens, tables, temps, top_ks,
                                top_ps)                  # (max_batch, h)
            for r in decode_reqs:
                row = self._row_of[r.request_id]
                # take tokens until stop/max; tokens past a stop are
                # discarded (their KV lands beyond the final length)
                for i in range(toks.shape[1]):
                    tok_i = int(toks[row, i])
                    self._lengths[row] += 1
                    r.output_tokens.append(tok_i)
                    emitted.setdefault(r.request_id, []).append(tok_i)
                    if (r.sampling.stop_tokens
                            and tok_i in r.sampling.stop_tokens):
                        break
                    if r.num_generated >= r.max_new_tokens:
                        break

        # ---- retire
        finished = []
        for r in list(self.scheduler.running.values()):
            reason = None
            if r.state == RequestState.ABORTED:
                reason = "abort"
            elif (r.sampling.stop_tokens and r.output_tokens
                    and r.output_tokens[-1] in r.sampling.stop_tokens):
                reason = "stop"
            elif r.num_generated >= r.max_new_tokens:
                reason = "length"
            if reason:
                if not r.is_done():
                    r.finish(reason)
                finished.append(r.request_id)
        for rid in finished:
            r = self.scheduler.running[rid]
            self._radix_commit(r)
            row = self._row_of.pop(rid, None)
            if row is not None:
                self._active[row] = False
                self._tables[row, :] = self._trash
            self._finish(r)
        if finished:
            self.scheduler.update(finished)
        return emitted

    def _finish(self, r: Request) -> None:
        total = (r.finish_time or time.monotonic()) - r.arrival_time
        self._results[r.request_id] = GenerationResult(
            request_id=r.request_id, tokens=list(r.output_tokens),
            finish_reason=r.finish_reason or "length",
            ttft_s=r.ttft(), total_s=total)
        with self._lock:
            self._total_tokens += len(r.output_tokens)

    def run_until_done(self, request_ids=None, max_steps: int = 100_000):
        for _ in range(max_steps):
            if request_ids is not None and all(
                    rid in self._results for rid in request_ids):
                return
            if request_ids is None and not (self.scheduler.waiting
                                            or self.scheduler.running):
                return
            self.step()

    def generate(self, req: GenerationRequest) -> GenerationResult:
        rid = self.submit_request(req)
        self.run_until_done([rid])
        return self._results[rid]

    def get_result(self, request_id: str):
        return self._results.get(request_id)

    def stats(self) -> dict:
        s = {
            "total_requests": self._total_requests,
            "total_tokens": self._total_tokens,
            "radix_hit_tokens": self._radix_hit_tokens,
            "scheduler": self.scheduler.stats(),
            "pool": self.pool.stats(),
            "prefill_compile": self._prefill_cache.stats(),
        }
        if self.radix is not None:
            s["radix"] = self.radix.stats()
        return s
