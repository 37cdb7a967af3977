"""Slot inference engine: scheduler + KV slot pool + captured dispatch steps
(counterpart: physics_llm_inference_tpu/serve/engine.py).

- A *slot pool*: KV caches shaped (L, num_slots, max_seq, ·), plain or the
  INT8 QuantKV layout. Each running request owns one slot; slot bookkeeping
  reuses PagedKVCache with block_size = max_seq (one block is one slot), so
  admission and preemption flow through the Scheduler's hooks.
- One decode dispatch for the whole pool (batch = num_slots, fixed shape)
  over a horizon of steps, at per-slot lengths and sampling parameters;
  inactive slots are parked at the last position.
- Prefill runs per request at bucketed chunk lengths, into the request's
  slot; `speculative_k` verifies prompt-lookup drafts in one
  (num_slots, k+1) window (runtime/speculative.py).

The host logic of `step()` is the JAX engine's, line for line, so the same
request stream gives the same `dispatch_trace`. What differs:
- The pools are torch tensors on the device of the parameters, written in
  place by the model; a `torch.Generator` stands where the JAX engine
  splits a PRNG key.
- Dispatch steps are cached as the JAX engine caches its jitted steps:
  prefill chunks in a `StepCache` keyed by the bucket
  (`stats()["prefill_compile"]`), decode horizons keyed by (horizon,
  filtered), the verify window by its width. On CUDA each is a CUDA graph
  over static input buffers (`staged_step`), each graph in a memory pool
  of its own; on the CPU the steps run eagerly. Sampling
  scalars reach the steps as device tensors.
- A prefill chunk runs on a static (L, 1, S, ·) slot buffer: the request's
  slot is copied into it before the chunk and back after it, by two copies
  outside the graph at the slot's host index (the JAX engine slices the
  slot out and sets it back). A graph cannot take a different slot view per
  request, and a capture's warm-up run then writes only the buffer.
- A parked row's horizon walks past the cache: on the per-op route its
  writes land on S - 1, as JAX clamps them (models/transformer.forward),
  and K4 drops them; its tokens are discarded either way.
- The request lifecycle (intake with stream listeners, abort,
  `generate_stream`, `wait_result`) is serve/lifecycle.py's, shared with
  the paged engine: a listener is registered in the critical section that
  makes the request schedulable, so a stream misses no token.
- `mesh` (parallel/mesh.py, axes data x model): one engine a rank, each
  rank's the same host logic (parallel/multihost.DPServingGroup keeps the
  ranks' request streams identical). The params are this rank's Megatron
  shard (parallel/tp.tp_prepare_params) and the steps run on the local
  config, whose row-parallel sums and logits gather go over the `model`
  axis. The pool holds this rank's KV heads of its data rank's
  num_slots / data slots: a prefill chunk runs on the ranks of the slot's
  data rank alone, which broadcast its first token over `data`; a decode
  step runs each data rank's slots, and the sampled tokens are gathered
  over `data`, so every rank's scheduler, slots and results stay those of
  the single-process engine. Under a mesh the steps run eagerly on any
  backend: a gloo collective is a host call, which a CUDA graph cannot
  capture (capture under NCCL is open work). Speculative decoding under a
  mesh raises, as the JAX engine asserts.
On CUDA with INT8 weights and an INT8 pool, prefill linears run K1 (and K5
from 512 slots of context), a decode step that passes the fused gate runs
K4, the others K1 and K2.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import KVSlice, QuantKV, forward
from ..ops.sampling import SamplingParams, sample_token
from ..runtime.paged_kv import PagedKVCache
from ..runtime.speculative import NgramIndex, _verify_window
from ..runtime.step_cache import StepCache, bucket_for, staged_step
from ..sched.request import Request, RequestState
from ..sched.scheduler import Scheduler, SchedulerConfig, SchedulingPolicy
# the request records are also this module's names, as in the JAX package
from .lifecycle import GenerationRequest, GenerationResult, RequestLifecycle

DEFAULT_PROMPT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


@dataclass
class EngineConfig:
    """Engine limits (ref ch10/engine.py:11-16) and the shape policy."""

    num_slots: int = 8              # decode batch == live requests
    max_seq_len: int = 512          # per-slot KV capacity
    max_new_tokens_cap: int = 256
    prompt_buckets: tuple = DEFAULT_PROMPT_BUCKETS
    # Prompts longer than this prefill in chunks of at most this size.
    max_prefill_chunk: int = 512
    # Mixed prefill/decode iterations: at most this many prompt tokens
    # prefill per engine iteration (may overshoot by one chunk); None -> one
    # chunk's worth (max_prefill_chunk).
    prefill_tokens_per_iter: int | None = None
    policy: SchedulingPolicy = SchedulingPolicy.FCFS
    kv_dtype: str | None = None     # default: model dtype
    # Multi-step scheduling: decode up to this many tokens per dispatch;
    # single steps while requests wait, horizon tokens past a stop or
    # max_tokens discarded. Power-of-two horizons, each its own step.
    decode_horizon: int = 8
    # Speculative decoding (greedy only): draft up to k tokens per
    # iteration by prompt lookup over each request's own history and verify
    # them in ONE (num_slots, k+1) forward; taken on iterations where every
    # active request is greedy. 0 = off.
    speculative_k: int = 0
    spec_ngram: int = 2


# ------------------------------------------------------- the step functions

def prefill_chunk(params, cfg: ModelConfig, ids, k_slot, v_slot, start,
                  nvalid, generator, temp, top_k, top_p) -> torch.Tensor:
    """One (possibly chunked) prefill pass of the JAX engine's `prefill`:
    ids (1, C) holds prompt tokens [start, start + nvalid) right-padded to
    the bucket; K/V land at slots [start, start + C) of the slot caches
    (L, 1, S, ·), written in place (padding slots are overwritten by the
    next chunk or decode before they are attended: the slot <= q mask).
    start and nvalid are 0-d tensors; temp and top_p 0-d, top_k (1,).
    Returns the token sampled from the last valid position, (1,) int32."""
    b, c = ids.shape
    slots = (torch.arange(c, device=ids.device)[None, :] + start).expand(b, c)
    logits, _ = forward(params, ids, cfg, kv=KVSlice(k_slot, v_slot, start),
                        positions=slots, slots=slots)
    # nvalid as a (1,) index: a 0-d tensor index is read on the host
    last = logits[torch.arange(b, device=ids.device),
                  (nvalid - 1).reshape(-1)]
    return sample_token(last, generator, temperature=temp, top_k=top_k,
                        top_p=top_p).to(torch.int32)


def decode_horizon(params, cfg: ModelConfig, k, v, tokens, lengths,
                   generator, temps, top_ks, top_ps, horizon: int,
                   filtered: bool) -> torch.Tensor:
    """`horizon` decode steps of the whole pool, sampling included, with no
    host sync (the JAX engine's `decode` scan): tokens and lengths (B,)
    are each slot's last token and fill. `filtered=False` is the variant
    without top-k/top-p (no per-step vocab sort). Returns (B, horizon)
    int32."""
    tok, lens, out = tokens, lengths, []
    for _ in range(horizon):
        logits, _ = forward(params, tok[:, None], cfg,
                            kv=KVSlice(k, v, lens), last_only=True)
        tok = sample_token(logits[:, 0], generator, temperature=temps,
                           top_k=top_ks if filtered else 0,
                           top_p=top_ps if filtered else None
                           ).to(torch.int32)
        out.append(tok)
        lens = lens + 1
    return torch.stack(out, dim=1)


def _slot_of_cache(cache, slot: int):
    """The (L, 1, S, ·) view of one slot of a pool, plain or QuantKV."""
    if isinstance(cache, QuantKV):
        return QuantKV(cache.q[:, slot:slot + 1], cache.s[:, slot:slot + 1])
    return cache[:, slot:slot + 1]


def _copy_cache(dst, src) -> None:
    if isinstance(dst, QuantKV):
        dst.q.copy_(src.q)
        dst.s.copy_(src.s)
    else:
        dst.copy_(src)


class InferenceEngine(RequestLifecycle):
    def __init__(self, params, model_cfg: ModelConfig,
                 config: EngineConfig | None = None, mesh=None):
        """params: the port's parameter dict (the full model, also under a
        mesh); the pools are made on the device of the params, or of the
        mesh. mesh: a (data, model) Mesh of more than one rank serves
        sharded (the module's docstring); its steps run eagerly."""
        self.mesh = mesh if (mesh is not None and mesh.world > 1) else None
        self.cfg = model_cfg
        self.config = c = config or EngineConfig()
        self._run_cfg = model_cfg   # the config the steps run on
        self._dp, self._data_rank = 1, 0
        if self.mesh is not None:
            params = self._shard(params, model_cfg)
        self.params = params
        self.device = dev = params["embed"].device
        self._slots_local = c.num_slots // self._dp

        kv_dtype = getattr(torch, c.kv_dtype or model_cfg.dtype)
        nl, hkv, hd = (model_cfg.num_layers, self._run_cfg.num_kv_heads,
                       model_cfg.head_dim)

        def pool(slots):
            if kv_dtype == torch.int8:
                # QuantKV: flat int8 values and transposed f32 scales; the
                # decode step runs the INT8-KV kernels
                return QuantKV(
                    q=torch.zeros((nl, slots, c.max_seq_len, hkv * hd),
                                  dtype=torch.int8, device=dev),
                    s=torch.zeros((nl, slots, hkv, c.max_seq_len),
                                  dtype=torch.float32, device=dev))
            return torch.zeros((nl, slots, c.max_seq_len, hkv, hd),
                               dtype=kv_dtype, device=dev)

        self._k, self._v = pool(self._slots_local), pool(self._slots_local)
        # the slot buffers every prefill chunk runs on
        self._slot_k, self._slot_v = pool(1), pool(1)

        # slot bookkeeping: one "block" per slot
        self._slot_pool = PagedKVCache(num_blocks=c.num_slots,
                                       block_size=c.max_seq_len)
        self.scheduler = Scheduler(
            SchedulerConfig(max_batch_size=c.num_slots,
                            max_tokens_per_batch=c.num_slots * c.max_seq_len,
                            policy=c.policy),
            kv_pool=self._slot_pool)
        self._slot_of: dict[str, int] = {}
        self._lengths = np.zeros(c.num_slots, dtype=np.int32)
        self._active = np.zeros(c.num_slots, dtype=bool)
        self._prefilling: list = []  # admitted, prefill_pos < prompt_len

        self._init_lifecycle()
        gen_dev = dev if dev.type == "cuda" else "cpu"
        # one stream a data rank (the JAX engine folds the data index in)
        self._rng = torch.Generator(device=gen_dev).manual_seed(
            self._data_rank)
        # aggregate stats (ref ch10/engine.py:200-211)
        self._start = time.monotonic()

        self._prefill_cache = StepCache(self._make_prefill)
        self._decode_fns: dict[tuple, tuple] = {}
        self._spec_step = None   # the verify window, made at first use
        # speculative decoding state: per-slot token history + n-gram index
        if c.speculative_k > 0:
            self._spec_hist = np.zeros((c.num_slots, c.max_seq_len),
                                       dtype=np.int32)
            self._spec_pos = np.zeros(c.num_slots, dtype=np.int32)
            self._spec_idx: dict[int, object] = {}
            self._spec_accept_hist: list[float] = []
        # (kind, shape-params, slots) of every dispatch when a list
        self.dispatch_trace: list | None = None

    def _shard(self, params, cfg: ModelConfig) -> dict:
        """Check the mesh, set the local config, and return this rank's
        shard of the params."""
        from ..parallel.tp import tp_local_config, tp_prepare_params

        c, shape = self.config, self.mesh.shape
        if set(shape) != {"data", "model"}:
            raise ValueError(f"the slot engine serves on a (data, model) "
                             f"mesh, not {shape}")
        self._dp, tp = shape["data"], shape["model"]
        if c.num_slots % self._dp:
            raise ValueError(f"num_slots {c.num_slots} must divide the data "
                             f"axis {self._dp}")
        if c.speculative_k > 0:
            raise ValueError("speculative decoding is single-device "
                             "(host-side drafting)")
        self._data_rank = self.mesh.index("data")
        if tp > 1:
            self._run_cfg = tp_local_config(cfg, tp, mesh=self.mesh)
        print(f"[engine] mesh {shape} ({self.mesh.transport}): dispatch "
              f"steps run eagerly, no CUDA graph capture", file=sys.stderr)
        return tp_prepare_params(params, cfg, self.mesh)

    def _pick_horizon(self) -> int:
        """Largest power-of-two horizon that fits every active slot's
        remaining KV capacity; 1 while requests are waiting (admission
        latency beats dispatch amortization when there's queued work)."""
        if (self.scheduler.waiting or self._prefilling
                or self.config.decode_horizon <= 1):
            return 1
        active = self._lengths[self._active]
        room = self.config.max_seq_len - 1 - (int(active.max()) if
                                              active.size else 0)
        h = 1
        while h * 2 <= min(self.config.decode_horizon, max(1, room)):
            h *= 2
        return h

    # ------------------------------------------------------------ dispatch

    def _buf(self, *shape, fill=0, dtype=torch.int32) -> torch.Tensor:
        return torch.full(shape, fill, dtype=dtype, device=self.device)

    def _make_prefill(self, cb: int):
        """The prefill chunk step of bucket `cb` on the slot buffers. Its
        buffers start at start 0: a capture's warm-up writes only the
        slot buffers, which every chunk refills first."""
        def fn(ids, start, nvalid, temp, top_k, top_p):
            return prefill_chunk(self.params, self._run_cfg, ids,
                                 self._slot_k, self._slot_v, start, nvalid,
                                 self._rng, temp, top_k, top_p)

        buf = self._buf
        return staged_step(fn, self.device, (self._rng,),
                           capture=self.mesh is None, ids=buf(1, cb),
                           start=buf(), nvalid=buf(fill=1),
                           temp=buf(dtype=torch.float32), top_k=buf(1),
                           top_p=buf(fill=1, dtype=torch.float32))

    def _prefill(self, slot: int, ids, pos: int, n: int,
                 sampling: SamplingParams) -> torch.Tensor | None:
        """One chunk into `slot`: the slot copied into the slot buffers, the
        bucket's step, the buffers copied back. Returns the sampled token,
        (1,) on the device (the step's output, overwritten by its next
        run); None on a rank whose data rank does not hold the slot."""
        # every rank looks the step up, so the StepCache stats agree
        inputs, step = self._prefill_cache.get(ids.shape[1])
        owner, local = divmod(slot, self._slots_local)
        if owner != self._data_rank:
            return None
        _copy_cache(self._slot_k, _slot_of_cache(self._k, local))
        _copy_cache(self._slot_v, _slot_of_cache(self._v, local))
        inputs.load(ids=ids, start=pos, nvalid=n,
                    temp=sampling.temperature,
                    top_k=np.full(1, sampling.top_k, np.int32),
                    top_p=sampling.top_p)
        tok = step()
        _copy_cache(_slot_of_cache(self._k, local), self._slot_k)
        _copy_cache(_slot_of_cache(self._v, local), self._slot_v)
        return tok

    def _first_token(self, slot: int, tok) -> int:
        """The token a request's last prefill chunk sampled, on every rank:
        broadcast over `data` from the slot's data rank."""
        if self._dp > 1:
            if tok is None:
                tok = torch.zeros(1, dtype=torch.int32, device=self.device)
            tok = self.mesh.broadcast(tok, "data",
                                      src=slot // self._slots_local)
        return int(tok[0])

    def _decode_for(self, horizon: int, filtered: bool):
        """The multi-step decode of this horizon: (inputs, step). Its
        buffers start with every row parked at the last position, so a
        capture's warm-up writes nothing that is ever attended."""
        key = (horizon, filtered)
        if key not in self._decode_fns:
            c, buf = self.config, self._buf

            def fn(tokens, lengths, temps, top_ks, top_ps):
                return decode_horizon(self.params, self._run_cfg, self._k,
                                      self._v, tokens, lengths, self._rng,
                                      temps, top_ks, top_ps, horizon,
                                      filtered)

            n = self._slots_local
            self._decode_fns[key] = staged_step(
                fn, self.device, (self._rng,),
                capture=self.mesh is None, tokens=buf(n),
                lengths=buf(n, fill=c.max_seq_len - 1),
                temps=buf(n, fill=1, dtype=torch.float32),
                top_ks=buf(n), top_ps=buf(n, fill=1, dtype=torch.float32))
        return self._decode_fns[key]

    def _decode(self, horizon: int, filtered: bool, tokens, lens, temps,
                top_ks, top_ps) -> np.ndarray:
        """The horizon over every slot: this data rank's rows decoded
        here, the others' gathered over `data`. Returns (num_slots,
        horizon) tokens."""
        inputs, step = self._decode_for(horizon, filtered)
        rows = slice(self._data_rank * self._slots_local,
                     (self._data_rank + 1) * self._slots_local)
        inputs.load(tokens=tokens[rows], lengths=lens[rows],
                    temps=temps[rows], top_ks=top_ks[rows],
                    top_ps=top_ps[rows])
        toks = step()
        if self._dp > 1:
            toks = self.mesh.all_gather(toks, "data", dim=0)
        return toks.cpu().numpy()

    def _spec_for(self, w: int):
        """The verify window of width w = speculative_k + 1: (inputs,
        step). Its buffers start with every row parked where the JAX engine
        parks idle rows."""
        if self._spec_step is None:
            c, buf = self.config, self._buf

            def fn(window, starts):
                # engine slots have no left padding: positions are slots
                return _verify_window(self.params, self.cfg, window, self._k,
                                      self._v, starts, starts, None)

            self._spec_step = staged_step(
                fn, self.device,
                window=buf(c.num_slots, w),
                starts=buf(c.num_slots, fill=c.max_seq_len - 1 - w))
        return self._spec_step

    def _verify(self, window, starts) -> np.ndarray:
        inputs, step = self._spec_for(window.shape[1])
        inputs.load(window=window, starts=starts)
        return step().cpu().numpy()

    # ------------------------------------------------- speculative decoding

    def _spec_emit(self, slot: int, tok: int) -> None:
        """Append an emitted token to the slot's history + n-gram index."""
        pos = int(self._spec_pos[slot])
        if pos >= self.config.max_seq_len:
            return
        self._spec_hist[slot, pos] = tok
        self._spec_pos[slot] = pos + 1
        idx = self._spec_idx.get(slot)
        if idx is not None:
            idx.add(self._spec_hist[slot], pos + 1 - self.config.spec_ngram)

    def _spec_iteration(self, decode_reqs, emitted) -> None:
        """One speculative decode dispatch: draft k tokens per slot from
        its own history, verify in one (num_slots, k+1) forward, greedily
        accept the matching prefix + the model's bonus token."""
        c = self.config
        w = c.speculative_k + 1
        ns = c.num_slots
        window = np.zeros((ns, w), dtype=np.int32)
        drafts = np.zeros((ns, c.speculative_k), dtype=np.int32)
        starts = np.full(ns, c.max_seq_len - 1 - w, dtype=np.int32)
        for r in decode_reqs:
            s = self._slot_of[r.request_id]
            window[s, 0] = r.output_tokens[-1]
            idx = self._spec_idx.get(s)
            if idx is not None:
                drafts[s] = idx.propose(self._spec_hist[s],
                                        int(self._spec_pos[s]),
                                        c.speculative_k)
            window[s, 1:] = drafts[s]
            starts[s] = self._lengths[s]
        if self.dispatch_trace is not None:
            self.dispatch_trace.append(
                ("spec", w, tuple(int(self._slot_of[r.request_id])
                                  for r in decode_reqs)))
        preds = self._verify(window, starts)
        accepted_total = 0
        for r in decode_reqs:
            s = self._slot_of[r.request_id]
            stopped = False

            def emit_one(tok_i):
                nonlocal stopped, accepted_total
                self._lengths[s] += 1
                r.output_tokens.append(tok_i)
                emitted.setdefault(r.request_id, []).append(tok_i)
                self._spec_emit(s, tok_i)
                self._notify(r, tok_i)
                accepted_total += 1
                if ((r.sampling.stop_tokens
                     and tok_i in r.sampling.stop_tokens)
                        or r.num_generated >= r.max_new_tokens):
                    stopped = True

            m = 0
            while (m < c.speculative_k and not stopped
                   and drafts[s, m] == preds[s, m]):
                emit_one(int(drafts[s, m]))
                m += 1
            if not stopped:
                emit_one(int(preds[s, m]))
        self._spec_accept_hist.append(accepted_total / len(decode_reqs))

    def warmup(self, buckets=None) -> float:
        """Make every power-of-two decode horizon up to decode_horizon
        (unfiltered; filtered too at horizon 1) and each prompt bucket up to
        max_seq_len (on CUDA: capture them), and the verify window with
        speculative_k, and run each once: decode with every row parked,
        prefill on the slot buffers alone. Returns the seconds it took."""
        t0 = time.monotonic()
        c = self.config
        horizons = {1}
        hh = 1
        while hh * 2 <= c.decode_horizon:
            hh *= 2
            horizons.add(hh)
        parked = np.full(c.num_slots, c.max_seq_len - 1, np.int32)
        for h in sorted(horizons):
            # the no-filter variant is the serving fast path; the filtered
            # one at horizon 1 too, for the first sampled request
            for filtered in ([False] if h > 1 else [False, True]):
                self._decode(h, filtered, np.zeros(c.num_slots, np.int32),
                             parked, np.ones(c.num_slots, np.float32),
                             np.zeros(c.num_slots, np.int32),
                             np.ones(c.num_slots, np.float32))
        if c.speculative_k > 0:
            w = c.speculative_k + 1
            self._verify(np.zeros((c.num_slots, w), np.int32),
                         np.full(c.num_slots, c.max_seq_len - 1 - w,
                                 np.int32))
        for pb in (buckets or c.prompt_buckets):
            if pb > c.max_seq_len:
                continue
            inputs, step = self._prefill_cache.get(pb)
            inputs.load(ids=np.zeros((1, pb), np.int32), start=0, nvalid=1,
                        temp=0.0, top_k=np.zeros(1, np.int32), top_p=1.0)
            step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.monotonic() - t0

    # ------------------------------------------------------------- requests

    def submit_request(self, req: GenerationRequest,
                       listener: list | None = None) -> str:
        """Thread-safe intake (ref submit_request ch10/engine.py:72-94).
        `listener`, a list, receives each emitted token from the first."""
        rid = self._new_id(req)
        if len(req.prompt_tokens) + req.max_tokens > self.config.max_seq_len:
            raise ValueError(
                f"prompt+max_tokens {len(req.prompt_tokens)}+{req.max_tokens} "
                f"exceeds max_seq_len {self.config.max_seq_len}")
        r = Request(
            request_id=rid,
            prompt_tokens=list(req.prompt_tokens),
            max_new_tokens=min(req.max_tokens, self.config.max_new_tokens_cap),
            sampling=SamplingParams(temperature=req.temperature,
                                    top_k=req.top_k, top_p=req.top_p,
                                    stop_tokens=tuple(req.stop_tokens)),
        )
        self._enqueue(r, listener)
        return rid

    # ----------------------------------------------------------------- step

    def step(self) -> dict[str, list[int]]:
        """One engine iteration: schedule -> prefill admitted -> decode
        running -> retire finished. Returns {request_id: [tokens emitted
        this step]}. Holds the engine lock for the whole iteration:
        concurrent callers would race the scheduler; an RLock, so _finish
        can re-acquire."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> dict[str, list[int]]:
        out = self.scheduler.schedule()
        emitted: dict[str, list[int]] = {}

        for r in out.preempted:
            slot = self._slot_of.pop(r.request_id, None)
            if slot is not None:
                self._active[slot] = False
            r.output_tokens.clear()

        # prefill admitted requests, one slot each, chunked for long
        # prompts; at most `prefill_tokens_per_iter` of chunks run per
        # iteration, a longer prompt carries prefill_pos into the next, so
        # the decode dispatch below runs between its chunks
        for r in out.prefill:
            slot = self._slot_pool.tables[r.request_id].block_ids[0]
            self._slot_of[r.request_id] = slot
            r.start_time = r.start_time or time.monotonic()
            self._prefilling.append(r)
        budget = (self.config.prefill_tokens_per_iter
                  or self.config.max_prefill_chunk)
        still_prefilling = []
        for r in self._prefilling:
            slot = self._slot_of.get(r.request_id)
            if slot is None or r.is_done():   # preempted/aborted meanwhile
                continue
            if budget <= 0:
                still_prefilling.append(r)
                continue
            p = len(r.prompt_tokens)
            tok = None
            pos = r.prefill_pos
            while pos < p and budget > 0:
                n = min(p - pos, self.config.max_prefill_chunk)
                c_bucket = bucket_for(n, self.config.prompt_buckets)
                ids = np.zeros((1, c_bucket), dtype=np.int32)
                ids[0, :n] = r.prompt_tokens[pos:pos + n]
                if self.dispatch_trace is not None:
                    self.dispatch_trace.append(
                        ("prefill", c_bucket, slot, pos, n))
                tok = self._prefill(slot, ids, pos, n, r.sampling)
                pos += n
                budget -= n
                r.prefill_pos = pos
            if pos < p:                       # budget ran out mid-prompt
                still_prefilling.append(r)
                continue
            self._lengths[slot] = p
            self._active[slot] = True
            # sampled from the final chunk's last token
            tok_i = self._first_token(slot, tok)
            r.first_token_time = time.monotonic()
            r.output_tokens.append(tok_i)
            emitted.setdefault(r.request_id, []).append(tok_i)
            if self.config.speculative_k > 0:
                self._spec_hist[slot, :p] = r.prompt_tokens
                self._spec_pos[slot] = p
                self._spec_idx[slot] = NgramIndex(
                    self._spec_hist[slot], 0, p, self.config.spec_ngram)
                self._spec_emit(slot, tok_i)
            self._notify(r, tok_i)
        self._prefilling = still_prefilling

        # one decode dispatch for the whole pool (mid-prefill requests have
        # no first token yet: they join once their prefill completes)
        decode_reqs = [r for r in out.decode
                       if r.request_id in self._slot_of and not r.is_done()
                       and r.output_tokens]
        if decode_reqs:
            tokens = np.zeros(self.config.num_slots, dtype=np.int32)
            temps = np.ones(self.config.num_slots, dtype=np.float32)
            top_ks = np.zeros(self.config.num_slots, dtype=np.int32)
            top_ps = np.ones(self.config.num_slots, dtype=np.float32)
            for r in decode_reqs:
                s = self._slot_of[r.request_id]
                tokens[s] = r.output_tokens[-1]
                temps[s] = r.sampling.temperature
                top_ks[s] = r.sampling.top_k
                top_ps[s] = r.sampling.top_p
            h = self._pick_horizon()
            # the no-filter variant skips the per-step vocab sort when no
            # active request asks for top-k/top-p
            filtered = bool((top_ks > 0).any() or (top_ps < 1.0).any())
            # speculative iteration: all-greedy, capacity for the window
            ds = [self._slot_of[r.request_id] for r in decode_reqs]
            if (self.config.speculative_k > 0 and not filtered
                    and bool((temps[ds] == 0.0).all())
                    and bool((self._lengths[ds] + self.config.speculative_k
                              + 1 < self.config.max_seq_len).all())):
                self._spec_iteration(decode_reqs, emitted)
                decode_reqs = []
        if decode_reqs:
            if self.dispatch_trace is not None:
                self.dispatch_trace.append(
                    ("decode", h, filtered,
                     tuple(int(self._slot_of[r.request_id])
                           for r in decode_reqs)))
            # the fixed-shape decode writes K/V at every slot's length: park
            # INACTIVE slots (mid-prefill ones included) at the last
            # position, which no active row attends
            lens = self._lengths.copy()
            lens[~self._active] = self.config.max_seq_len - 1
            toks = self._decode(h, filtered, tokens, lens, temps, top_ks,
                                top_ps)                  # (num_slots, h)
            for r in decode_reqs:
                s = self._slot_of[r.request_id]
                # take horizon tokens until stop/max; tokens generated past
                # a stop are discarded (their KV writes are beyond the
                # request's final length and never attended)
                for i in range(toks.shape[1]):
                    tok_i = int(toks[s, i])
                    self._lengths[s] += 1
                    r.output_tokens.append(tok_i)
                    emitted.setdefault(r.request_id, []).append(tok_i)
                    if self.config.speculative_k > 0:
                        # keep the slot's draft history current even when
                        # an iteration took the normal decode path
                        self._spec_emit(s, tok_i)
                    self._notify(r, tok_i)
                    if (r.sampling.stop_tokens
                            and tok_i in r.sampling.stop_tokens):
                        break
                    if r.num_generated >= r.max_new_tokens:
                        break

        # retire
        finished: list[str] = []
        for r in list(self.scheduler.running.values()):
            reason = None
            if r.state == RequestState.ABORTED:
                reason = "abort"
            elif (r.sampling.stop_tokens and r.output_tokens
                    and r.output_tokens[-1] in r.sampling.stop_tokens):
                reason = "stop"
            elif r.num_generated >= r.max_new_tokens:
                reason = "length"
            elif self._slot_of.get(r.request_id) is not None and \
                    self._lengths[self._slot_of[r.request_id]] + 1 >= \
                    self.config.max_seq_len:
                reason = "length"
            if reason:
                if not r.is_done():
                    r.finish(reason)
                finished.append(r.request_id)
        if finished:
            for rid in finished:
                r = self.scheduler.running[rid]
                slot = self._slot_of.pop(rid, None)
                if slot is not None:
                    self._active[slot] = False
                self._finish(r)
            self.scheduler.update(finished)
        return emitted

    def stats(self) -> dict:
        """Aggregate throughput (ref get_stats ch10/engine.py:200-211) and
        component stats: plain Python values, so /metrics serializes."""
        elapsed = time.monotonic() - self._start
        out = {
            "total_requests": self._total_requests,
            "total_tokens": self._total_tokens,
            "tokens_per_s": self._total_tokens / elapsed if elapsed else 0.0,
            "scheduler": self.scheduler.stats(),
            "prefill_compile": self._prefill_cache.stats(),
            "active_slots": int(self._active.sum()),
        }
        if self.config.speculative_k > 0:
            hist = self._spec_accept_hist
            out["speculative"] = {
                "dispatches": len(hist),
                "tokens_per_dispatch": (sum(hist) / len(hist)) if hist
                else 0.0,
                "draft_k": self.config.speculative_k,
            }
        return out
