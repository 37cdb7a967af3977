"""K12: elementwise add over (N, C) arrays, the one-kernel template.

Replaces the TPU kernel `physics_llm_inference_tpu/kernels/hello_pallas.py`
`vector_add` (`_add_kernel`). The CUDA kernel is `csrc/vector_add.cu`: bound
by bytes (one add per 12 bytes in f32), a grid-stride loop over 16-byte
vectors streams a and b in and the sum out; bf16 is summed in f32 and
rounded once, bit-equal to `torch.add`.

`vector_add` is the entry point: it checks what the TPU kernel asserts
(2-D, equal shapes, rows divisible by the clamped `block_rows`), then a CPU
tensor goes to `vector_add_plain` and a CUDA tensor to the kernel, or
raises on what the kernel does not take. `block_rows` is the TPU kernel's
row block; the CUDA kernel has its own.
"""
from __future__ import annotations

import torch

from . import _build

launches = 0  # kernel launches made by vector_add (the chip smoke reads it)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def vector_add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch: a + b."""
    return a + b


def vector_add(a: torch.Tensor, b: torch.Tensor,
               block_rows: int = 256) -> torch.Tensor:
    """a + b over (N, C)-shaped arrays of one dtype (f32 or bf16 on CUDA)."""
    global launches
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"vector_add takes two 2-D arrays of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    rows = a.shape[0]
    br = min(block_rows, rows)
    if br <= 0 or rows % br:
        raise ValueError(f"{rows} rows not divisible by block_rows {br}")
    if not a.is_cuda:
        return vector_add_plain(a, b)
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"vector_add on CUDA takes f32 or bf16 of one dtype, "
                        f"got {a.dtype} and {b.dtype}")
    if b.device != a.device or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("vector_add needs contiguous tensors on one device")
    out = torch.empty_like(a)
    vec = int(all(t.data_ptr() % 16 == 0 for t in (a, b, out)))
    err = _build.lib().pli_vector_add(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), _DTYPES[a.dtype],
        vec, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "vector_add")
    launches += 1
    return out
