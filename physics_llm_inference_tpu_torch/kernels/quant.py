"""INT8 quantization primitives (counterpart: physics_llm_inference_tpu/kernels/quant.py).

Symmetric per-axis absmax quantization: s = max(absmax, eps) / 127,
q = clip(round(x / s), -127, 127). Plain tensor ops, not kernels.
`torch.round` rounds half to even like `jnp.round`, so the int8 values
match the JAX package exactly on the same f32 inputs.
"""
from __future__ import annotations

import torch

INT8_MAX = 127.0


def quantize_int8(x: torch.Tensor, axis: int | tuple[int, ...] = -1,
                  eps: float = 1e-8):
    """Returns (q int8, scale f32); `axis` is the axis (or axes) reduced to
    compute absmax, so the scale broadcasts over it."""
    xf = x.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    scale = absmax.clamp_min(eps) / INT8_MAX
    q = torch.round(xf / scale).clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
