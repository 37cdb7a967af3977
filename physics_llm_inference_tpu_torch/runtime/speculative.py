"""Speculative decoding: prompt-lookup (n-gram) drafting + batched greedy
verification (counterpart: physics_llm_inference_tpu/runtime/
speculative.py).

Each step drafts up to `k` tokens by matching the sequence's own history
(the "prompt lookup" scheme, no draft model) and verifies them in ONE cached
forward over a (B, k+1) window. Greedy verification accepts the longest
prefix whose tokens match the model's argmax at each position, then takes
the model's own next token as a bonus, so outputs equal one-token greedy
decoding while repetitive text decodes several tokens per model pass.

The verify window is a fixed (B, k+1) forward; drafts are padded, and
rejected positions' KV writes are overwritten by the next window before they
can be attended (the write lands before the read inside block_forward, and
attention masks k_slot <= q_slot). `NgramIndex` and `ngram_propose` are
host-only copies of the originals; the window runs the port's `forward`, on
the device of the parameters, eagerly.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..models.config import ModelConfig, refuse_mla
from ..models.transformer import KVSlice, forward
from .generate import GenerationOutput, _prefill, _sync, pad_and_stack
from .kv_cache import KVCache


class NgramIndex:
    """Incremental n-gram -> latest-position index over one request's
    history.

    Replaces an O(length) right-to-left rescan per request per step with an
    O(1) dict lookup, and never indexes the left-pad region (a trailing
    n-gram of a ragged batch member must not match pad zeros). Each key
    keeps its two most recent start positions so a lookup can skip the
    occurrence that IS the current trailing n-gram."""

    def __init__(self, history: np.ndarray, first_real: int, length: int,
                 ngram: int):
        self.n = ngram
        self.first_real = first_real
        # key -> (latest_start, previous_start | -1)
        self.idx: dict[tuple, tuple[int, int]] = {}
        for start in range(first_real, length - ngram + 1):
            self.add(history, start)

    def add(self, history: np.ndarray, start: int) -> None:
        if start < self.first_real:
            return
        key = tuple(int(t) for t in history[start:start + self.n])
        prev = self.idx.get(key)
        self.idx[key] = (start, prev[0] if prev else -1)

    def propose(self, history: np.ndarray, length: int, k: int) -> np.ndarray:
        """Draft up to k tokens by copying what followed the most recent
        EARLIER occurrence of the trailing n-gram. Returns (k,) int32
        (zero-padded when no match / short match)."""
        out = np.zeros(k, dtype=np.int32)
        if length - self.first_real <= self.n:
            return out
        key = tuple(int(t) for t in history[length - self.n:length])
        hit = self.idx.get(key)
        if hit is None:
            return out
        start = hit[0] if hit[0] < length - self.n else hit[1]
        if start < 0:
            return out
        src = history[start + self.n:min(start + self.n + k, length)]
        out[:len(src)] = src
        return out


def ngram_propose(history: np.ndarray, length: int, k: int,
                  ngram: int = 2, first_real: int = 0) -> np.ndarray:
    """One-shot wrapper around NgramIndex. `first_real` is the first non-pad
    position of a left-padded history."""
    return NgramIndex(history, first_real, length, ngram).propose(
        history, length, k)


def _verify_window(params, cfg: ModelConfig, window: torch.Tensor, kv_k,
                   kv_v, starts: torch.Tensor, pos0: torch.Tensor,
                   valid_from: torch.Tensor | None):
    """Forward a (B, k+1) window at per-request cache offsets; returns the
    argmax tokens (B, k+1) int32 at each window position (caches written in
    place).

    `starts` are CACHE SLOTS; `pos0` are RoPE positions of window[:, 0];
    they differ under left padding (position counts from the first real
    prompt token, slots from the bucket start)."""
    b, w = window.shape
    ar = torch.arange(w, device=window.device)[None, :]
    slots = starts[:, None] + ar
    logits, _ = forward(params, window, cfg, kv=KVSlice(kv_k, kv_v, starts),
                        positions=pos0[:, None] + ar, slots=slots,
                        valid_from=valid_from)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def speculative_generate(params, cfg: ModelConfig, prompts,
                         max_new_tokens: int, draft_k: int = 4,
                         ngram: int = 2, stop_tokens: tuple[int, ...] = (),
                         pad_id: int = 0, prompt_bucket: int | None = None,
                         kv_dtype=None) -> GenerationOutput:
    """Greedy generation with prompt-lookup speculation on the device of
    `params["embed"]`.

    Output tokens equal cached_generate(temperature=0)'s; steps where drafts
    are accepted advance several tokens per model pass. The returned
    GenerationOutput carries `extras` (model passes, tokens per pass)."""
    refuse_mla(cfg, "speculative decoding")
    device = params["embed"].device
    ids, lens = pad_and_stack(prompts, pad_id=pad_id, bucket=prompt_bucket,
                              device=device)
    b, p = ids.shape
    w = draft_k + 1
    cache = KVCache.create(cfg, b, p + max_new_tokens + w, dtype=kv_dtype,
                           device=device)

    _sync(device)
    t0 = time.perf_counter()
    logits0, kv, valid_from = _prefill(params, cfg, ids, lens,
                                       cache.as_slice())
    first = torch.argmax(logits0, dim=-1).cpu().numpy().astype(np.int32)
    prefill_s = time.perf_counter() - t0

    # host-side history per request: left-padded prompt + generated
    hist = np.zeros((b, p + max_new_tokens + w), dtype=np.int32)
    hist[:, :p] = ids.cpu().numpy()
    lens_np = lens.cpu().numpy()
    gen_counts = np.zeros(b, dtype=np.int32)
    frontier = np.full(b, p, dtype=np.int32)  # next cache slot per request
    tokens = np.full((b, max_new_tokens), pad_id, dtype=np.int32)
    done = np.zeros(b, dtype=bool)
    stops = set(stop_tokens)

    first_real = p - lens_np  # first non-pad slot per request
    indexes = [NgramIndex(hist[i], int(first_real[i]), p, ngram)
               for i in range(b)]

    def emit(i, tok):
        if done[i] or gen_counts[i] >= max_new_tokens:
            done[i] = True
            return
        tokens[i, gen_counts[i]] = tok
        hist[i, frontier[i]] = tok
        gen_counts[i] += 1
        frontier[i] += 1
        indexes[i].add(hist[i], frontier[i] - ngram)
        if tok in stops or gen_counts[i] >= max_new_tokens:
            done[i] = True

    for i in range(b):
        emit(i, int(first[i]))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    model_passes = 0
    t0 = time.perf_counter()
    while not done.all():
        window = np.zeros((b, w), dtype=np.int32)
        drafts = np.zeros((b, draft_k), dtype=np.int32)
        for i in range(b):
            window[i, 0] = hist[i, frontier[i] - 1]
            drafts[i] = indexes[i].propose(hist[i], int(frontier[i]),
                                           draft_k)
            window[i, 1:] = drafts[i]
        pos0 = lens_np + gen_counts - 1  # rope position of window[:, 0]
        preds = _verify_window(params, cfg, dev(window), kv.k, kv.v,
                               dev(frontier - 1), dev(pos0),
                               valid_from).cpu().numpy()
        model_passes += 1
        for i in range(b):
            if done[i]:
                continue
            # accept drafts while they match the model's own argmax, then
            # take the model's next token as the bonus
            m = 0
            while m < draft_k and drafts[i, m] == preds[i, m] \
                    and not done[i]:
                emit(i, int(drafts[i, m]))
                m += 1
            if not done[i]:
                emit(i, int(preds[i, m]))
    decode_s = time.perf_counter() - t0

    total = int(gen_counts.sum())
    out = GenerationOutput(tokens=tokens, prompt_lens=lens_np.astype(np.int32),
                           gen_lens=gen_counts, prefill_s=prefill_s,
                           decode_s=decode_s)
    out.extras = {  # type: ignore[attr-defined]
        "model_passes": model_passes,
        "tokens_per_pass": total / max(1, model_passes),
        "draft_k": draft_k,
    }
    return out
