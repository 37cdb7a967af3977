"""K10/K11: the memory-access microbenchmark (contiguous stream vs strided
gather) and its two copies.

Replaces the TPU kernels `physics_llm_inference_tpu/kernels/membench.py`
`_stream_copy` (K10) and `_strided_copy` (K11), both `_copy_kernel`. The
CUDA kernel is `csrc/membench.cu`: one row-block copy, bound by bytes, that
copies `block_rows` rows from input row block `i * stride` to output block
`i`, one 16-byte vector a thread, as PyTorch's elementwise copy launches
(the fastest of the forms timed on the H100: PERF.md, K10 and K11); stride
1 is K10, stride 32 with 8-row blocks is K11. Each entry point has its own
launch counter (`stream_launches`, `strided_launches`).

On a CPU tensor each entry point takes its plain twin (an indexed clone);
on a CUDA tensor it launches the kernel or raises. `measure_access_patterns`
keeps the JAX package's dict and byte counts; it times with
`utils.timing.benchmark_fn` (CUDA events after an L2-flushing write on the
card, so the strided copy's 8 MiB cannot be served from L2) and caps the
size at 8 MB off the card, as the JAX package does off the TPU.
"""
from __future__ import annotations

import torch

from ..utils.timing import benchmark_fn
from . import _build

stream_launches = 0   # kernel launches made by _stream_copy
strided_launches = 0  # kernel launches made by _strided_copy


def _row_blocks_plain(x: torch.Tensor, block_rows: int, stride: int,
                      num_blocks: int) -> torch.Tensor:
    """Rows [i * stride * block_rows, + block_rows) for i < num_blocks, as a
    new tensor (num_blocks * block_rows, lanes)."""
    starts = torch.arange(num_blocks, device=x.device) * (stride * block_rows)
    idx = (starts[:, None]
           + torch.arange(block_rows, device=x.device)[None, :]).reshape(-1)
    return x.index_select(0, idx)


def _stream_copy_plain(x: torch.Tensor, block_rows: int = 2048) -> torch.Tensor:
    return _row_blocks_plain(x, block_rows, 1, x.shape[0] // block_rows)


def _strided_copy_plain(x: torch.Tensor, block_rows: int = 8,
                        stride: int = 32) -> torch.Tensor:
    return _row_blocks_plain(x, block_rows, stride,
                             x.shape[0] // (block_rows * stride))


def _row_block_copy(x: torch.Tensor, block_rows: int, stride: int,
                    num_blocks: int) -> torch.Tensor:
    """Launch the CUDA row-block copy; returns (num_blocks * block_rows,
    lanes)."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"the copy takes a contiguous 2-D array, got "
                         f"{tuple(x.shape)}")
    out = torch.empty((num_blocks * block_rows, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    block_bytes = block_rows * x.shape[1] * x.element_size()
    vec = int(block_bytes % 16 == 0 and x.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    err = _build.lib().pli_row_block_copy(
        x.data_ptr(), out.data_ptr(), num_blocks, block_bytes, stride, vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "row_block_copy")
    return out


def _stream_copy(x: torch.Tensor, block_rows: int = 2048) -> torch.Tensor:
    """Contiguous copy of x (N, lanes) in row blocks of `block_rows`. The
    TPU kernel leaves rows past the last whole block unwritten; this one
    raises on such an N."""
    global stream_launches
    n = x.shape[0]
    if block_rows <= 0 or n % block_rows:
        raise ValueError(f"{n} rows not divisible by block_rows {block_rows}")
    if not x.is_cuda:
        return _stream_copy_plain(x, block_rows)
    out = _row_block_copy(x, block_rows, 1, n // block_rows)
    stream_launches += 1
    return out


def _strided_copy(x: torch.Tensor, block_rows: int = 8,
                  stride: int = 32) -> torch.Tensor:
    """Every `stride`-th block of `block_rows` rows of x (N, lanes) ->
    (N // (block_rows * stride) * block_rows, lanes)."""
    global strided_launches
    if block_rows <= 0 or stride <= 0:
        raise ValueError("block_rows and stride must be positive")
    if not x.is_cuda:
        return _strided_copy_plain(x, block_rows, stride)
    out = _row_block_copy(x, block_rows, stride,
                          x.shape[0] // (block_rows * stride))
    strided_launches += 1
    return out


def measure_access_patterns(total_mb: int = 256, stride: int = 32,
                            iters: int = 10, device="cuda") -> dict:
    """Contiguous stream vs strided gather bandwidth over an f32
    (total_mb MiB / 512 B, 128) array on `device`."""
    if torch.device(device).type != "cuda":
        total_mb = min(total_mb, 8)
    rows = total_mb * (1 << 20) // (128 * 4)
    x = torch.ones((rows, 128), dtype=torch.float32, device=device)
    nbytes = x.numel() * x.element_size()

    t_stream = benchmark_fn(_stream_copy, x, iters=iters,
                            name="stream copy").mean_ms / 1e3
    stream_gbps = 2 * nbytes / t_stream / 1e9  # read + write

    t_strided = benchmark_fn(_strided_copy, x, stride=stride, iters=iters,
                             name="strided copy").mean_ms / 1e3
    touched = 2 * nbytes / stride
    strided_gbps = touched / t_strided / 1e9

    return {
        "stream_gbps": stream_gbps,
        "strided_gbps": strided_gbps,
        "stride": stride,
        "slowdown": stream_gbps / strided_gbps if strided_gbps else 0.0,
    }
