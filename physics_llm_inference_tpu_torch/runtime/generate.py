"""KV-cached two-phase generation and the no-cache loop (counterpart:
physics_llm_inference_tpu/runtime/generate.py:36-269).

Prompts are LEFT-padded to a bucket so every request's next slot is the same
integer; RoPE positions and `valid_from` are per request. Prefill is one
forward over the padded prompt (the fresh-KV branch); decode is a plain
Python loop of one-token forwards. The loop makes no host sync per token:
tokens and the stop flags stay on the device until the end. (A captured
CUDA graph is the Hopper form of the JAX package's in-jit `lax.scan`; it is
a later step.) Phase times come from `time.perf_counter` around work that
ends in `torch.cuda.synchronize()` on the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import KVSlice, forward
from ..ops.sampling import sample_token
from .kv_cache import KVCache
from .step_cache import DEFAULT_SEQ_BUCKETS, bucket_for


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


def _prefill(params, cfg: ModelConfig, ids, lens, kv: KVSlice):
    """One forward over the whole left-padded prompt into slots [0, p).
    Returns (last-position logits (B, V), kv, valid_from)."""
    b, p = ids.shape
    slots = torch.arange(p, device=ids.device)[None, :].expand(b, p)
    positions = (slots - (p - lens)[:, None]).clamp_min(0)
    valid_from = (p - lens).to(torch.int32)
    logits, kv = forward(params, ids, cfg, kv=kv, positions=positions,
                         slots=slots, valid_from=valid_from, last_only=True,
                         k_limit=p, fresh_kv=True)
    return logits[:, 0], kv, valid_from


def _decode_loop(params, cfg: ModelConfig, kv: KVSlice, first_token, lens,
                 valid_from, generator, num_steps: int, temperature,
                 top_k: int, top_p, stop_tokens, pad_id: int, greedy: bool,
                 prompt_bucket: int):
    """num_steps one-token forwards; returns (B, num_steps) tokens including
    the first, with pad_id after a request's stop token."""
    b = first_token.shape[0]
    dev = first_token.device
    stops = (torch.as_tensor(stop_tokens, dtype=torch.int32, device=dev)
             if stop_tokens else None)
    tok = first_token.to(torch.int32)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    emitted = []
    for i in range(num_steps):
        emitted.append(torch.where(done, torch.full_like(tok, pad_id), tok))
        slot = prompt_bucket + i
        slots = torch.full((b, 1), slot, dtype=torch.int32, device=dev)
        positions = (lens + i)[:, None]
        step_kv = KVSlice(kv.k, kv.v, slot)
        if greedy:
            nxt, kv = forward(params, tok[:, None], cfg, kv=step_kv,
                              positions=positions, slots=slots,
                              valid_from=valid_from, last_only=True,
                              greedy_head=True)
        else:
            logits, kv = forward(params, tok[:, None], cfg, kv=step_kv,
                                 positions=positions, slots=slots,
                                 valid_from=valid_from, last_only=True)
            nxt = sample_token(logits[:, 0], generator,
                               temperature=temperature, top_k=top_k,
                               top_p=top_p)
        if stops is not None:
            done = done | (tok[:, None] == stops[None, :]).any(dim=-1)
        tok = nxt.to(torch.int32)
    return torch.stack(emitted, dim=1), kv


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cached_generate(params, cfg: ModelConfig, prompts, max_new_tokens: int,
                    generator: torch.Generator | None = None,
                    temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 1.0, stop_tokens: tuple[int, ...] = (),
                    pad_id: int = 0, prompt_bucket: int | None = None,
                    kv_dtype=None) -> GenerationOutput:
    """Two-phase KV-cached generation on the device of `params["embed"]`.

    prompts: list of token-id lists (ragged ok). kv_dtype=torch.int8 selects
    the INT8 cache. Greedy (temperature 0, no filters) decodes through the
    fused greedy head."""
    device = params["embed"].device
    ids, lens = pad_and_stack(prompts, pad_id=pad_id, bucket=prompt_bucket,
                              device=device)
    b, p = ids.shape
    # on the card the capacity rounds up to a multiple of 128, as on the TPU;
    # decode masks slots past q_slot, so the tail costs nothing but memory
    s_total = p + max_new_tokens
    if device.type == "cuda":
        s_total = -(-s_total // 128) * 128
    cache = KVCache.create(cfg, b, s_total, dtype=kv_dtype, device=device)

    _sync(device)
    t0 = time.perf_counter()
    logits0, kv, valid_from = _prefill(params, cfg, ids, lens,
                                       cache.as_slice())
    has_top_p = top_p < 1.0
    first = sample_token(logits0, generator, temperature=temperature,
                         top_k=top_k, top_p=top_p if has_top_p else None)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    greedy = float(temperature) == 0.0 and top_k == 0 and not has_top_p
    t0 = time.perf_counter()
    tokens, _ = _decode_loop(params, cfg, kv, first, lens, valid_from,
                             generator, max_new_tokens, temperature, top_k,
                             top_p if has_top_p else None, stop_tokens,
                             pad_id, greedy, p)
    tokens = tokens.cpu().numpy().astype(np.int32)
    _sync(device)
    decode_s = time.perf_counter() - t0

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
