"""RMSNorm (counterpart: physics_llm_inference_tpu/ops/norms.py)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) * weight over the last axis; the reduction runs in f32 and
    the result is cast back to x's dtype."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(ms + eps)
    return (normed * weight.float()).to(x.dtype)
