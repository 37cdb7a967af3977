"""Attention ops + memory/FLOPs accounting (counterpart:
physics_llm_inference_tpu/ops/attention.py).

Scores and softmax in f32 from the input-dtype operands, the weights cast
back to the input dtype before the value product (accumulated in f32), the
output in the input dtype, as the JAX package's `_sdpa` with
`preferred_element_type=f32`. `probe_attention_memory` runs on the card
unless the caller passes `device="cpu"`; its flash branch is the port's
flash_attention (K5).
"""
from __future__ import annotations

import math

import torch

_NEG_INF = -1e30  # finite large-negative: avoids NaN from (-inf) - (-inf)


def _sdpa(q, k, v, mask=None, scale=None):
    """Scaled dot-product attention over (..., S, D) with an optional bool
    mask (True = keep). Scores/softmax in f32, output cast to q.dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, _NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = weights.to(q.dtype).float() @ v.float()
    return out.to(q.dtype)


def naive_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention."""
    return _sdpa(q, k, v)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     offset: int = 0) -> torch.Tensor:
    """Causal attention; `offset` places q at positions [offset, offset+Sq)
    of a K/V of length Sk (the rectangular prefill/decode case)."""
    sq, sk = q.shape[-2], k.shape[-2]
    qi = torch.arange(sq, device=q.device)[:, None] + offset
    ki = torch.arange(sk, device=q.device)[None, :]
    return _sdpa(q, k, v, mask=ki <= qi)


def multi_head_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                         wv: torch.Tensor, wo: torch.Tensor, num_heads: int,
                         causal: bool = True) -> torch.Tensor:
    """Full MHA over (B, S, D) with weight matrices (D, D): gqa_attention
    with num_kv_heads == num_heads."""
    from .gqa import gqa_attention

    return gqa_attention(x, wq, wk, wv, wo, num_heads, num_heads,
                         causal=causal)


# --- analysis ----------------------------------------------------------------

def attention_flops(batch: int, heads: int, seq: int, head_dim: int) -> int:
    """FLOPs of the two score/value matmuls: 2 * (2·S²·D) per head."""
    return batch * heads * (2 * seq * seq * head_dim) * 2


def attention_memory_bytes(batch: int, heads: int, seq: int, head_dim: int,
                           dtype_bytes: int = 2) -> dict:
    """Device-memory bytes of naive attention: Q/K/V/O plus the
    materialized (S, S) score + weight matrices that flash attention
    eliminates."""
    qkvo = 4 * batch * heads * seq * head_dim * dtype_bytes
    scores = 2 * batch * heads * seq * seq * dtype_bytes
    return {"qkvo_bytes": qkvo, "scores_bytes": scores,
            "total_bytes": qkvo + scores}


def attention_arithmetic_intensity(batch: int, heads: int, seq: int,
                                   head_dim: int,
                                   dtype_bytes: int = 2) -> float:
    """FLOP/byte of naive attention."""
    flops = attention_flops(batch, heads, seq, head_dim)
    mem = attention_memory_bytes(batch, heads, seq, head_dim, dtype_bytes)
    return flops / mem["total_bytes"]


def max_attendable_seq(hbm_budget_bytes: int, batch: int, heads: int,
                       head_dim: int, dtype_bytes: int = 2,
                       flash: bool = False) -> int:
    """Largest S whose attention working set fits a memory budget: naive
    attention is quadratic in S (materialized scores), flash linear."""
    lo, hi = 0, 1 << 24
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        m = attention_memory_bytes(batch, heads, mid, head_dim, dtype_bytes)
        used = m["qkvo_bytes"] if flash else m["total_bytes"]
        if used <= hbm_budget_bytes:
            lo = mid
        else:
            hi = mid
    return lo


def probe_attention_memory(batch: int = 1, heads: int = 32,
                           head_dim: int = 128, start_seq: int = 1024,
                           max_seq: int = 1 << 20, flash: bool = False,
                           dtype=None, device=None) -> dict:
    """DEVICE probe of the longest attendable context: doubles S until the
    allocation or computation runs out of device memory. Returns per-S
    results plus the first failing S. Only `torch.cuda.OutOfMemoryError`
    ends the sweep as a boundary; any other error (a failed kernel launch,
    the CPU allocator's RuntimeError) propagates, where the JAX package
    catches every exception and would report it as the boundary."""
    dev = torch.device("cuda" if device is None else device)
    dtype = dtype or torch.bfloat16
    itemsize = torch.empty((), dtype=dtype).element_size()
    results, failed_at = [], None
    s = start_seq
    while s <= max_seq:
        try:
            g = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn((batch, heads, s, head_dim), generator=g,
                                   device=dev, dtype=dtype) for _ in "qkv")
            if flash:
                from ..kernels.flash_attention import flash_attention

                out = flash_attention(q, k, v, causal=True)
            else:
                out = causal_attention(q, k, v)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            m = attention_memory_bytes(batch, heads, s, head_dim, itemsize)
            results.append({"seq": s, "ok": True,
                            "predicted_bytes": (m["qkvo_bytes"] if flash
                                                else m["total_bytes"])})
            del q, k, v, out
        except torch.cuda.OutOfMemoryError as e:
            failed_at = s
            results.append({"seq": s, "ok": False,
                            "error": type(e).__name__})
            break
        s *= 2
    q = k = v = out = None  # the failed size's tensors, before the release
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"results": results, "failed_at": failed_at, "flash": flash,
            "max_ok": max((r["seq"] for r in results if r["ok"]),
                          default=0)}
