"""Plain float32 building blocks that the architectures' references share,
in plain torch. They import nothing of the port.

The int8 formats are part of a configuration's stated precision: a matrix
is its int8 codes times its scales (exact in float32), and keys and values
pass through the int8 cache format (per token and head, absmax / 127,
rounded half to even, clipped to +-127). `dequant(..., int4=True)` is the
control's step below int8: every matrix re-quantized to int4 (groups of
128 input rows per output channel, absmax / 7, round, clip to [-8, 7]).
`mm_bf16` is the witness's product: inputs and output rounded to
bfloat16, as a program with bfloat16 activations rounds them.
"""
from __future__ import annotations

import torch

INT4_GROUP = 128


def f32_matmuls() -> None:
    """Float32 products with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dequant(q: torch.Tensor, s: torch.Tensor, int4: bool) -> torch.Tensor:
    w = q.float() * s.float()
    if not int4:
        return w
    k, n = w.shape
    g = w.reshape(k // INT4_GROUP, INT4_GROUP, n)
    scale = g.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 7.0
    return (torch.round(g / scale).clamp_(-8, 7) * scale).reshape(k, n)


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with its inputs and output rounded to bfloat16 (the witness)."""
    return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).float()


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def kv_int8(t: torch.Tensor) -> torch.Tensor:
    """(T, H, hd) through the int8 cache format, per token and head."""
    scale = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(t / scale).clamp_(-127, 127) * scale


def rope(t: torch.Tensor, theta: float) -> torch.Tensor:
    """(T, H, hd) rotated by positions 0..T-1 (rotate-half)."""
    n, _, hd = t.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=t.device) / hd)
    ang = torch.arange(n, dtype=torch.float32, device=t.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = t[..., :hd // 2], t[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)
