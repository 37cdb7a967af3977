"""Rotary position embeddings (counterpart: physics_llm_inference_tpu/ops/rope.py).

Precomputed (cos, sin) tables gathered by position; half-split rotation
(rotate_half), the Llama-family convention.
"""
from __future__ import annotations

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
    """Rotate x (B, S, H, D) by per-token positions (B, S)."""
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    xf = x.float()
    d2 = x.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
