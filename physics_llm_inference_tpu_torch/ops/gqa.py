"""Grouped-query attention (counterpart: physics_llm_inference_tpu/ops/gqa.py:19-120).

The JAX package computes this in XLA, not in Pallas, so plain torch is its
faithful counterpart. Queries are reshaped to (B, Hkv, group, Sq, D) and
contracted against the unexpanded K/V; both contractions accumulate in f32
(the JAX `preferred_element_type=f32`), and the softmax weights are cast to
the input dtype before the value contraction, as in the reference.
"""
from __future__ import annotations

import math

import torch

from .rope import apply_rope

_NEG_INF = -1e30


def grouped_sdpa(q, k, v, mask=None, scale=None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); Hq % Hkv == 0.
    mask: broadcastable to (B, Hkv, group, Sq, Sk), True = attend."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError("num_heads must be divisible by num_kv_heads")
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, sq, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", weights.to(q.dtype).float(),
                       v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def gqa_attention(x, wq, wk, wv, wo, num_heads: int, num_kv_heads: int,
                  causal: bool = True, rope_cos=None, rope_sin=None,
                  positions=None):
    """GQA over x (B, S, D): project, optional RoPE, grouped SDPA, output
    projection (counterpart: ops/gqa.py:78-113). wq: (D, Hq·hd), wk/wv:
    (D, Hkv·hd), wo: (Hq·hd, D)."""
    b, s, _ = x.shape
    head_dim = wq.shape[1] // num_heads
    q = (x @ wq).reshape(b, s, num_heads, head_dim)
    k = (x @ wk).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ wv).reshape(b, s, num_kv_heads, head_dim)
    if rope_cos is not None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        q = apply_rope(q, rope_cos, rope_sin, positions)
        k = apply_rope(k, rope_cos, rope_sin, positions)
    mask = None
    if causal:
        idx = torch.arange(s, device=x.device)
        mask = idx[None, :] <= idx[:, None]
    out = grouped_sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       mask=mask)
    out = out.transpose(1, 2).reshape(b, s, num_heads * head_dim)
    return out @ wo


def kv_cache_bytes_per_token(num_kv_heads: int, head_dim: int,
                             dtype_bytes: int = 2) -> int:
    """2 · Hkv · D · bytes, per token per layer."""
    return 2 * num_kv_heads * head_dim * dtype_bytes
