"""KV-cached two-phase generation and the no-cache loop (counterpart:
physics_llm_inference_tpu/runtime/generate.py:36-269).

Prompts are LEFT-padded to a bucket so every request's next slot is the same
integer; RoPE positions and `valid_from` are per request. Prefill is one
forward over the padded prompt (the fresh-KV branch). Decode is one step
over state that lives on the device (`DecodeLoop`: the step index, the
current token, the stop flags, the emitted tokens and the KV cache), run
`num_steps` times: on the card as one CUDA graph replayed (the Hopper form
of the JAX package's `lax.scan` under `_decode_jit`), on the CPU eagerly.
The graph advances its own step index, so nothing of a step is a host
value. A `StepCache` keyed by what fixes the step's shapes keeps captured
loops for later calls, as the JAX package's compile cache keeps
`_decode_jit`. Phase times come from `time.perf_counter` around work that
ends in `torch.cuda.synchronize()` on the card. A prefill of more than
`PREFILL_TOKENS` padded tokens runs in slices of whole rows, each writing
its rows of the cache, so its transient memory is bounded by the slice.
Each call records a `generate.prefill` and a `generate.decode` span
(utils/tracing.py; key: the call's number in the process; attributes: the
rows, the prompt bucket, the new tokens, the cache's kind and its bytes a
token over every layer; the decode's, where the grouped expert kernels ran
in it, also `expert_tiles_live` and `expert_tiles`, the m16 slot tiles
they worked on and all of them, from `kernels/moe_experts.tile_counter`,
zeroed before the decode), on the host clock after each phase's
synchronization.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import moe_experts
from ..models.config import ModelConfig
from ..models.transformer import KVSlice, forward
from ..models.mla import LatentKV
from ..models.transformer import QuantKV
from ..ops.sampling import sample_token
from ..utils import tracing
from .kv_cache import KVCache
from .step_cache import DEFAULT_SEQ_BUCKETS, CapturedStep, StepCache, \
    bucket_for


def pad_and_stack(prompts, pad_id: int = 0, bucket: int | None = None,
                  buckets=DEFAULT_SEQ_BUCKETS, device=None):
    """LEFT-pad ragged prompts to a common bucketed length.
    Returns (ids (B, P) int64, lens (B,) int64) on `device`."""
    lens = np.array([len(p) for p in prompts], dtype=np.int64)
    p_len = bucket or bucket_for(int(lens.max()), buckets)
    ids = np.full((len(prompts), p_len), pad_id, dtype=np.int64)
    for i, p in enumerate(prompts):
        ids[i, p_len - len(p):] = np.asarray(p, dtype=np.int64)
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(lens).to(device))


@dataclass
class GenerationOutput:
    """Tokens + phase timings."""

    tokens: np.ndarray        # (B, max_new) int32, pad_id after stop
    prompt_lens: np.ndarray   # (B,)
    gen_lens: np.ndarray      # (B,) tokens actually generated (stop-aware)
    prefill_s: float
    decode_s: float

    @property
    def ttft_s(self) -> float:
        return self.prefill_s

    @property
    def decode_tokens_per_s(self) -> float:
        total = int(self.gen_lens.sum())
        return total / self.decode_s if self.decode_s > 0 else 0.0

    @property
    def time_per_output_token_s(self) -> float:
        steps = int(self.tokens.shape[1])
        return self.decode_s / max(1, steps - 1)


# padded prompt tokens one prefill forward takes at most (whole rows)
PREFILL_TOKENS = 1 << 16
_calls = itertools.count()


def _rows(cache, r0: int, r1: int):
    """Rows [r0, r1) of a stacked cache (L, B, ...), as views."""
    if cache is None:
        return None
    if isinstance(cache, (QuantKV, LatentKV)):
        return type(cache)(cache.q[:, r0:r1], cache.s[:, r0:r1])
    return cache[:, r0:r1]


def _prefill(params, cfg: ModelConfig, ids, lens, kv: KVSlice):
    """One forward over the whole left-padded prompt into slots [0, p), in
    slices of whole rows of at most PREFILL_TOKENS tokens (one slice
    unless the batch is larger). Returns (last-position logits (B, V), kv,
    valid_from)."""
    b, p = ids.shape
    slots = torch.arange(p, device=ids.device)[None, :].expand(b, p)
    positions = (slots - (p - lens)[:, None]).clamp_min(0)
    valid_from = (p - lens).to(torch.int32)
    step = max(1, PREFILL_TOKENS // p)
    out = []
    for r0 in range(0, b, step):
        r1 = min(b, r0 + step)
        part = kv if (r0, r1) == (0, b) else KVSlice(
            _rows(kv.k, r0, r1), _rows(kv.v, r0, r1), kv.start)
        logits, _ = forward(params, ids[r0:r1], cfg, kv=part,
                            positions=positions[r0:r1], slots=slots[r0:r1],
                            valid_from=valid_from[r0:r1], last_only=True,
                            k_limit=p, fresh_kv=True)
        out.append(logits[:, 0])
    logits = out[0] if len(out) == 1 else torch.cat(out)
    return logits, KVSlice(kv.k, kv.v, kv.start + p), valid_from


class DecodeLoop:
    """The decode loop's state on the device and its one step.

    Static buffers: the KV cache (B, capacity), the current token, each
    request's prompt length and first valid slot, the first decode slot
    (the prompt bucket), the step index, the stop flags and the emitted
    tokens (B, capacity), plus the sampling scalars. `begin` loads a call's
    inputs; each call of `step` emits the current token (pad_id after a
    request's stop), runs one forward at slot base + step and advances the
    step index, all on the device. The step's shapes are fixed by the
    batch, the capacity and the arguments of `__init__`. A sampled loop
    draws from a generator of its own on `gen_device` (None: the default
    generator), which `begin` sets to the caller's generator's state and
    `end` hands back, so a captured step draws as the caller's generator
    would, whichever generator the caller passes."""

    def __init__(self, params, cfg: ModelConfig, b: int, capacity: int,
                 kv_dtype, greedy: bool, top_k: int, has_top_p: bool,
                 stop_tokens: tuple, pad_id: int, gen_device=None):
        dev = params["embed"].device
        self.params, self.cfg = params, cfg
        self.generator = (None if gen_device is None
                          else torch.Generator(device=gen_device))
        self.greedy, self.top_k, self.pad_id = greedy, top_k, pad_id
        self.cache = KVCache.create(cfg, b, capacity, dtype=kv_dtype,
                                    device=dev)

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.tok = zeros(b, dtype=torch.int32)
        self.lens = zeros(b)
        self.valid_from = zeros(b, dtype=torch.int32)
        self.base = zeros()
        self.i = zeros()
        self.done = zeros(b, dtype=torch.bool)
        self.emitted = zeros(b, capacity, dtype=torch.int32)
        self.temperature = zeros(dtype=torch.float32)
        self.top_p = zeros(dtype=torch.float32) if has_top_p else None
        self.stops = (torch.as_tensor(stop_tokens, dtype=torch.int32,
                                      device=dev) if stop_tokens else None)

    def begin(self, first_token, lens, valid_from, prompt_bucket: int,
              temperature: float, top_p: float, generator=None) -> None:
        """Load one call's inputs (and `generator`'s state into the loop's
        own) and restart at step 0."""
        if self.generator is not None:
            self.generator.set_state(generator.get_state())
        self.tok.copy_(first_token)
        self.lens.copy_(lens)
        self.valid_from.copy_(valid_from)
        self.base.fill_(prompt_bucket)
        self.i.zero_()
        self.done.zero_()
        self.temperature.fill_(temperature)
        if self.top_p is not None:
            self.top_p.fill_(top_p)

    def step(self) -> None:
        b = self.tok.shape[0]
        tok = self.tok
        emit = torch.where(self.done, torch.full_like(tok, self.pad_id), tok)
        self.emitted.index_copy_(1, self.i.reshape(1), emit[:, None])
        slot = (self.base + self.i).expand(b)
        kv = KVSlice(self.cache.k, self.cache.v, slot)
        kw = dict(kv=kv, positions=(self.lens + self.i)[:, None],
                  slots=slot[:, None], valid_from=self.valid_from,
                  last_only=True)
        if self.greedy:
            nxt, _ = forward(self.params, tok[:, None], self.cfg,
                             greedy_head=True, **kw)
        else:
            logits, _ = forward(self.params, tok[:, None], self.cfg, **kw)
            nxt = sample_token(logits[:, 0], self.generator,
                               temperature=self.temperature,
                               top_k=self.top_k, top_p=self.top_p)
        if self.stops is not None:
            self.done |= (tok[:, None] == self.stops[None, :]).any(dim=-1)
        self.tok.copy_(nxt)
        self.i += 1

    def end(self, generator=None) -> None:
        """Hand the loop's generator state back to the caller's `generator`,
        which is then where the steps left it."""
        if self.generator is not None:
            generator.set_state(self.generator.get_state())


def decode_step_cache() -> StepCache:
    """A cache of decode loops for `cached_generate`'s `step_cache`: keyed
    by the parameters, the config, the batch, the cache capacity and type,
    greedy or not, the filters, the stop tokens, the pad id and, for a
    sampled loop, the device of the caller's generator (the loop draws from
    its own, loaded with the caller's state each call). On CUDA each entry
    holds its step captured as a CUDA graph. The cache keeps every entry's
    parameters and KV cache alive."""

    def make(params, cfg, b, capacity, kv_dtype, greedy, top_k, has_top_p,
             stop_tokens, pad_id, gen_device):
        params = params.obj   # _Same
        loop = DecodeLoop(params, cfg, b, capacity, kv_dtype, greedy, top_k,
                          has_top_p, stop_tokens, pad_id, gen_device)
        dev = params["embed"].device
        if dev.type != "cuda":
            return loop, loop.step
        return loop, CapturedStep(loop.step, dev, (loop.generator,))

    return StepCache(make)


class _Same:
    """A cache key element equal only to itself: the object it holds."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Same) and other.obj is self.obj


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cached_generate(params, cfg: ModelConfig, prompts, max_new_tokens: int,
                    generator: torch.Generator | None = None,
                    temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 1.0, stop_tokens: tuple[int, ...] = (),
                    pad_id: int = 0, prompt_bucket: int | None = None,
                    kv_dtype=None,
                    step_cache: StepCache | None = None) -> GenerationOutput:
    """Two-phase KV-cached generation on the device of `params["embed"]`.

    prompts: list of token-id lists (ragged ok). kv_dtype=torch.int8 selects
    the INT8 cache. Greedy (temperature 0, no filters) decodes through the
    fused greedy head. `step_cache` (from `decode_step_cache`) keeps the
    decode loop, captured on CUDA, for later calls of the same shapes;
    without one each call makes (and on CUDA captures) its own."""
    device = params["embed"].device
    ids, lens = pad_and_stack(prompts, pad_id=pad_id, bucket=prompt_bucket,
                              device=device)
    b, p = ids.shape
    # on the card the capacity rounds up to a multiple of 128, as on the TPU;
    # decode masks slots past q_slot, so the tail costs nothing but memory
    s_total = p + max_new_tokens
    if device.type == "cuda":
        s_total = -(-s_total // 128) * 128
    has_top_p = top_p < 1.0
    greedy = float(temperature) == 0.0 and top_k == 0 and not has_top_p
    # the loop is made (and captured, whose warm-up step writes slot 0)
    # before the prefill writes its cache
    cache = step_cache if step_cache is not None else decode_step_cache()
    gen_device = None if greedy or generator is None else generator.device
    loop, step = cache.get(_Same(params), cfg, b, s_total, kv_dtype, greedy,
                           top_k, has_top_p, tuple(stop_tokens), pad_id,
                           gen_device)

    call = next(_calls)
    attrs = {"rows": b, "prompt_bucket": p, "new_tokens": max_new_tokens,
             "cache": loop.cache.kind,
             "cache_bytes_per_token": loop.cache.bytes_per_token(cfg)}
    _sync(device)
    h0, t0 = tracing.now(), time.perf_counter()
    logits0, _, valid_from = _prefill(params, cfg, ids, lens,
                                      loop.cache.as_slice())
    first = sample_token(logits0, generator, temperature=temperature,
                         top_k=top_k, top_p=top_p if has_top_p else None)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    tracing.record("generate.prefill", h0, key=call, attrs=attrs)

    tiles = moe_experts.tile_counter(device)
    if tiles is not None:
        tiles.zero_()
    h0, t0 = tracing.now(), time.perf_counter()
    loop.begin(first, lens, valid_from, p, temperature, top_p, generator)
    for _ in range(max_new_tokens):
        step()
    loop.end(generator)
    tokens = loop.emitted[:, :max_new_tokens].cpu().numpy().astype(np.int32)
    _sync(device)
    decode_s = time.perf_counter() - t0
    decode_attrs = attrs
    if tiles is not None:
        live, total = tiles.tolist()
        if total:
            decode_attrs = {**attrs, "expert_tiles_live": live,
                            "expert_tiles": total}
    tracing.record("generate.decode", h0, key=call, attrs=decode_attrs)

    gen_lens = np.full((b,), tokens.shape[1], dtype=np.int32)
    if stop_tokens:
        for i in range(b):
            hits = np.isin(tokens[i], np.asarray(stop_tokens))
            if hits.any():
                stop_at = int(np.argmax(hits))
                gen_lens[i] = stop_at + 1
                tokens[i, stop_at + 1:] = pad_id
    return GenerationOutput(tokens=tokens,
                            prompt_lens=lens.cpu().numpy().astype(np.int32),
                            gen_lens=gen_lens, prefill_s=prefill_s,
                            decode_s=decode_s)


def naive_generate(params, cfg: ModelConfig, prompt_ids, max_new_tokens: int,
                   generator: torch.Generator | None = None,
                   temperature: float = 1.0, top_k: int = 0,
                   top_p: float = 1.0) -> np.ndarray:
    """No-cache autoregressive loop (counterpart: generate.py:228-269): every
    step re-runs the full uncached forward over the P+N buffer, padded up
    front as in the JAX package, and reads the logits at slot p + i - 1, so
    the total attention work is O(n^2). Equal-length prompts only. Runs on
    the device of `params["embed"]`; `generator` replaces the PRNG key.
    Returns the generated tokens (B, max_new_tokens) int32."""
    device = params["embed"].device
    ids = (prompt_ids if isinstance(prompt_ids, torch.Tensor)
           else torch.as_tensor(np.asarray(prompt_ids))).to(device)
    b, p = ids.shape
    buf = torch.zeros((b, p + max_new_tokens), dtype=torch.int64,
                      device=device)
    buf[:, :p] = ids
    has_top_p = top_p < 1.0
    toks = []
    for i in range(max_new_tokens):
        logits, _ = forward(params, buf, cfg)
        tok = sample_token(logits[:, p + i - 1], generator,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p if has_top_p else None)
        buf[:, p + i] = tok
        toks.append(tok)
    if not toks:
        return np.zeros((b, 0), dtype=np.int32)
    return torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)
