"""Perplexity harness: the quantization accuracy budget check (counterpart:
physics_llm_inference_tpu/bench/perplexity.py).

Windowed next-token NLL over a token stream, through the parallel forward
(`perplexity`) or through the decode path a token at a time over a KV
cache (`decode_path_perplexity`), plus the fp-vs-quantized delta report.
Everything runs on the device of `params["embed"]`: on the card the INT8
linears launch int8_matmul, and a decode step that passes the fused gate
(INT8 or INT4 block weights over an INT8 cache, batch a multiple of 8)
launches fused_decode_step in the weights' mode.

The JAX package jits one window's NLL and scans the decode steps; here
each window and each step is an eager forward, and the NLL sums stay f32
on the device until the window's end, as the JAX sums do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import forward
from ..runtime.kv_cache import KVCache


def _windows(token_ids, window: int) -> np.ndarray:
    """The token stream as (n_win, window) non-overlapping windows."""
    ids = np.asarray(token_ids, dtype=np.int64)
    n_win = len(ids) // window
    if n_win < 1:
        raise ValueError("token stream shorter than one window")
    return ids[:n_win * window].reshape(n_win, window)


def _nll(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Per-token NLL of `tgt` under `logits` (..., V), log-softmax in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, tgt[..., None])[..., 0]


def _window_nll(params, cfg: ModelConfig, ids: torch.Tensor):
    """Sum of next-token negative log-likelihoods over one (B, S) window."""
    logits, _ = forward(params, ids[:, :-1], cfg)
    nll = _nll(logits, ids[:, 1:])
    return nll.sum(), nll.numel()


def perplexity(params, cfg: ModelConfig, token_ids, window: int = 256,
               batch: int = 1) -> float:
    """exp(mean NLL) over non-overlapping windows of the token stream."""
    ids = _windows(token_ids, window)
    dev = params["embed"].device
    total, count = 0.0, 0
    for i in range(0, len(ids), batch):
        s, c = _window_nll(params, cfg, torch.from_numpy(ids[i:i + batch])
                           .to(dev))
        total += float(s)
        count += int(c)
    return float(np.exp(total / count))


def quantization_ppl_report(params_fp, params_q, cfg: ModelConfig,
                            token_ids, window: int = 256) -> dict:
    """fp vs quantized perplexity + the 0.1-budget verdict (BASELINE.md)."""
    ppl_fp = perplexity(params_fp, cfg, token_ids, window)
    ppl_q = perplexity(params_q, cfg, token_ids, window)
    delta = ppl_q - ppl_fp
    return {
        "ppl_fp": ppl_fp,
        "ppl_quantized": ppl_q,
        "delta": delta,
        "within_budget": abs(delta) <= 0.1,
    }


def _decode_path_nll(params, cfg: ModelConfig, ids: torch.Tensor,
                     kv_dtype=None):
    """Teacher-forced NLL through the DECODE path, the machinery serving
    uses (KV cache, INT8-KV attention, the fused whole-model decode kernel
    where its gate passes), not the parallel forward: token 0 is one
    one-token forward into an empty cache (the JAX package's first call
    has k_limit None, so not the fresh-KV branch), then one one-token
    forward a position, each scoring the next token. Each row of `ids` is a
    window. Returns (f32 NLL sum on the device, token count)."""
    b, n = ids.shape
    cache = KVCache.create(cfg, b, n, dtype=kv_dtype, device=ids.device)
    logits, kv = forward(params, ids[:, :1], cfg, kv=cache.as_slice(),
                         last_only=True, fresh_kv=False)
    total = _nll(logits[:, 0], ids[:, 1]).sum()
    for i in range(1, n - 1):
        logits, kv = forward(params, ids[:, i:i + 1], cfg,
                             kv=kv._replace(start=i), last_only=True)
        total = total + _nll(logits[:, 0], ids[:, i + 1]).sum()
    return total, b * (n - 1)


def decode_path_perplexity(params, cfg: ModelConfig, token_ids,
                           window: int = 256, kv_dtype=None) -> float:
    """exp(mean NLL) through the decode path (see _decode_path_nll)."""
    ids = torch.from_numpy(_windows(token_ids, window)).to(
        params["embed"].device)
    s, c = _decode_path_nll(params, cfg, ids, kv_dtype=kv_dtype)
    return float(np.exp(float(s) / int(c)))
