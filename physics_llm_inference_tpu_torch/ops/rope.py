"""Rotary position embeddings (counterpart: physics_llm_inference_tpu/ops/rope.py).

Precomputed (cos, sin) tables gathered by position; half-split rotation
(rotate_half), the Llama-family convention. DeepSeek-V2's rope (multi-head
latent attention, models/mla.py) takes YaRN's frequencies and attention
scale, computed from the positions, and de-interleaves its input's pairs
before rotate-half; the JAX package has neither.
"""
from __future__ import annotations

import math

import torch


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                     device=None):
    """(cos, sin) tables of shape (max_seq_len, head_dim // 2), f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    pos = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    angles = pos[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate x (B, S, H, D) by per-token positions (B, S). A position past
    the table reads its last row, as JAX clamps a gather."""
    positions = positions.clamp(0, cos.shape[0] - 1)
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    xf = x.float()
    d2 = x.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# YaRN, as DeepSeek-V2 publishes it (`DeepseekV2YarnRotaryEmbedding` and
# `yarn_*` in the model's modeling_deepseek.py; arXiv:2309.00071)

def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """0.1 * mscale * ln(factor) + 1 (1 for factor <= 1)."""
    if factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def _yarn_correction_dim(rotations: float, dim: int, base: float,
                         max_pos: int) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) / \
        (2 * math.log(base))


def yarn_inv_freq(dim: int, base: float, yarn, device=None) -> torch.Tensor:
    """(dim // 2,) f32 inverse frequencies: base's own (`freq_extra`) below
    the correction dim of `beta_fast` rotations over the original context,
    base's divided by `factor` (`freq_inter`) above that of `beta_slow`, and
    a linear ramp between."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (yarn.factor * base ** exps)
    low = max(math.floor(_yarn_correction_dim(
        yarn.beta_fast, dim, base, yarn.original_max_position_embeddings)), 0)
    high = min(math.ceil(_yarn_correction_dim(
        yarn.beta_slow, dim, base, yarn.original_max_position_embeddings)),
        dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    extra_mask = 1.0 - ramp
    return inter * (1 - extra_mask) + extra * extra_mask


def yarn_attention_scale(head_dim: int, yarn) -> float:
    """The softmax scale: head_dim**-0.5 times yarn_mscale(factor,
    mscale_all_dim) squared. The cos/sin tables' own factor
    mscale / mscale_all_dim is 1 at DeepSeek-V2's 0.707 / 0.707, and is
    applied in `yarn_cos_sin`."""
    m = yarn_mscale(yarn.factor, yarn.mscale_all_dim)
    return head_dim ** -0.5 * m * m


def yarn_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor, yarn):
    """(cos, sin) of positions (...) times inv_freq: (..., dim // 2) f32,
    each times mscale / mscale_all_dim."""
    ang = positions.float()[..., None] * inv_freq
    m = yarn_mscale(yarn.factor, yarn.mscale) / \
        yarn_mscale(yarn.factor, yarn.mscale_all_dim)
    return torch.cos(ang) * m, torch.sin(ang) * m


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V2's rope layout: pairs (0, 1), (2, 3), ... of the last axis
    become halves (the evens, then the odds) before rotate-half."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def apply_rope_deinterleaved(x: torch.Tensor, cos: torch.Tensor,
                             sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) de-interleaved, then rotated (rotate-half) by cos, sin
    (B, S, D // 2) in f32; the result in the de-interleaved layout, in x's
    dtype."""
    xf = deinterleave(x.float())
    d2 = x.shape[-1] // 2
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = xf[..., :d2], xf[..., d2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
