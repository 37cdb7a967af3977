"""K9: tiled GEMM, C = A @ B with f32 accumulation, cast to `out_dtype`.

Replaces the TPU kernel `physics_llm_inference_tpu/kernels/matmul.py`
`tiled_matmul` (`_matmul_kernel`). The CUDA kernel is
`csrc/tiled_matmul.cu`: bound by operations at the sizes it runs at, bf16
goes through the tensor cores (WMMA 16x16x16 from shared-memory tiles, a
128 x 128 tile a block, f32 accumulators in registers over the whole K
loop, one cast at the end); f32 runs in full f32 on the CUDA cores (a
register-blocked 8 x 8 tile a thread), so it agrees with `torch.matmul`
under `allow_tf32=False`. The CUDA tile masks ragged edges itself.

`tiled_matmul` is the entry point: it keeps the TPU kernel's arguments and
raises where it asserts (inner dims differ, a dim not divisible by its
clamped block), and raises on mixed dtypes; then a CPU tensor goes to
`tiled_matmul_plain` and a CUDA tensor to the kernel, or raises on what
the kernel does not take.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0  # kernel launches made by tiled_matmul (the chip smoke reads it)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """Plain torch: f32 products and sums, then the cast to `out_dtype`
    (default a's dtype)."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, block_m: int = 256,
                 block_n: int = 256, block_k: int = 512,
                 out_dtype=None) -> torch.Tensor:
    """C = A @ B. A: (M, K), B: (K, N), one dtype (bf16 or f32 on CUDA).
    Dims must divide by the block sizes after clamping, as on the TPU."""
    global launches
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("tiled_matmul takes two 2-D arrays")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch {k} vs {k2}")
    bm, bn, bk = min(block_m, m), min(block_n, n), min(block_k, k)
    if min(bm, bn, bk) <= 0 or m % bm or n % bn or k % bk:
        raise ValueError(f"shape ({m},{k})x({k},{n}) not divisible by blocks "
                         f"({bm},{bn},{bk})")
    if a.dtype != b.dtype:
        raise TypeError(f"tiled_matmul takes one dtype, got {a.dtype} and "
                        f"{b.dtype}")
    out_dtype = out_dtype or a.dtype
    if not a.is_cuda:
        return tiled_matmul_plain(a, b, out_dtype)
    if a.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError("tiled_matmul on CUDA takes f32 or bf16 in and out")
    if b.device != a.device or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("tiled_matmul needs contiguous tensors on one device")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    per = 16 // a.element_size()   # elements in a 16-byte vector
    vec_a = int(k % per == 0 and a.data_ptr() % 16 == 0)
    vec_b = int(n % per == 0 and b.data_ptr() % 16 == 0)
    err = _build.lib().pli_tiled_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, _DTYPES[a.dtype],
        _DTYPES[out_dtype], vec_a, vec_b,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "tiled_matmul")
    launches += 1
    return out
