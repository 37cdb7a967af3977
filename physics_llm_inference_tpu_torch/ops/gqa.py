"""Grouped-query attention (counterpart: physics_llm_inference_tpu/ops/gqa.py:19-39).

The JAX package computes this in XLA, not in Pallas, so plain torch is its
faithful counterpart. Queries are reshaped to (B, Hkv, group, Sq, D) and
contracted against the unexpanded K/V; both contractions accumulate in f32
(the JAX `preferred_element_type=f32`), and the softmax weights are cast to
the input dtype before the value contraction, as in the reference.
"""
from __future__ import annotations

import math

import torch

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
