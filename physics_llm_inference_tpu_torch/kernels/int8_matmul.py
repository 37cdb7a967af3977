"""K1: W8A16 matmul, out = (x @ w_q) * scale.

Replaces the TPU kernel `physics_llm_inference_tpu/kernels/int8_matmul.py`
`int8_matmul` (`_int8_matmul_kernel`). The CUDA kernel is
`csrc/int8_matmul.cu` (tile in `csrc/w8a16_tile.cuh`): bound by the int8
weight stream at decode sizes, it reads weights along N 16 bytes a thread,
converts them to bf16 in registers for the tensor cores, applies the scale
after the K sum, and splits K across blocks so that narrow N still fills the
card. Ragged M, N and K are masked; nothing needs to divide.

`int8_matmul` is the entry point: a CPU tensor goes to `int8_matmul_plain`
(the XLA path of the JAX package's `_linear`); a CUDA tensor goes to the
kernel, or raises on what the kernel does not take.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0  # kernel launches made by int8_matmul (the chip smoke reads it)

_BM = _BN = _BK = 64
_SMS = 132  # H100 SXM streaming multiprocessors


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                      layer: int | None = None, out_dtype=None) -> torch.Tensor:
    """Plain torch: int8 weights cast to f32 (exact), f32 products and
    accumulation, the per-column scale after the sum, then the cast to
    `out_dtype` (default x's dtype) — `transformer.py:138-143` in the JAX
    package. x: (M, K); w_q: (K, N) int8 or (L, K, N) with `layer`;
    scale: (1, N) or (L, 1, N) f32."""
    if w_q.dim() == 3:
        w_q, scale = w_q[layer], scale[layer]
    n = w_q.shape[-1]
    acc = x.float() @ w_q.float()
    return (acc * scale.reshape(1, n)).to(out_dtype or x.dtype)


def _split_k(m: int, n: int, k: int) -> tuple[int, int]:
    """(splits, k-tiles per split): split K until ~2 waves of blocks are in
    flight, keeping at least 8 K-tiles (512 columns of K) per split."""
    tiles = -(-n // _BN) * -(-m // _BM)
    k_tiles = -(-k // _BK)
    splits = min(max(1, -(-2 * _SMS // tiles)), max(1, k_tiles // 8))
    per = -(-k_tiles // splits)
    return -(-k_tiles // per), per


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                layer: int | None = None, out_dtype=None) -> torch.Tensor:
    """out = x @ (w_q * scale). x: (M, K); w_q: (K, N) int8 with scale (1, N)
    f32, or the full stacks (L, K, N) / (L, 1, N) with `layer` (a zero-copy
    view of that layer is handed to the kernel). Returns (M, N)."""
    global launches
    if not x.is_cuda:
        return int8_matmul_plain(x, w_q, scale, layer, out_dtype)
    if w_q.dim() == 3:
        if layer is None:
            raise ValueError("stacked weights need a layer index")
        w_q, scale = w_q[layer], scale[layer]
    m, k = x.shape
    k2, n = w_q.shape
    if k2 != k or scale.numel() != n:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w_q {tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    if x.dtype != torch.bfloat16 or (out_dtype or x.dtype) != torch.bfloat16:
        raise TypeError("int8_matmul on CUDA takes bf16 activations and "
                        "writes bf16")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("int8_matmul takes int8 weights and f32 scales")
    for t in (x, w_q, scale):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("int8_matmul needs contiguous tensors on one device")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0 or n == 0:
        return out
    splits, per = _split_k(m, n, k)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    vec_x = int(k % 8 == 0 and x.data_ptr() % 16 == 0)
    vec_w = int(n % 16 == 0 and w_q.data_ptr() % 16 == 0)
    err = _build.lib().pli_int8_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, n, k, splits, per,
        vec_x, vec_w, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_matmul")
    launches += 1
    return out
