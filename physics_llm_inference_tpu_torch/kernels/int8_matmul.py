"""K1: W8A16 matmul, out = (x @ w_q) * scale.

Replaces the TPU kernel `physics_llm_inference_tpu/kernels/int8_matmul.py`
`int8_matmul` (`_int8_matmul_kernel`). The CUDA kernels are in
`csrc/int8_matmul.cu`, two routes picked by `pick_route` from the shape, each
its own launch counter (`launches` counts both):
- "stream" (`stream_launches`), decode-sized M, bound by the weight bytes:
  the fused decode kernel's TMA weight stream (`csrc/w8a16_stream.cuh`) in
  an ordinary launch on a stream-K plan (`w8a16_stream.plan`), f32
  partials summed in a fixed order by a second launch;
- "wgmma" (`wgmma_launches`), prefill-sized M, bound by operations: y^T =
  w^T x^T on `wgmma`, the int8 weights widened to bf16 in the consumers'
  registers as its A, x read by TMA as its B; a block is 128 output columns
  x 128 or 256 rows (`_rows`), K split over blocks where the tiles alone
  leave SMs idle (`_splits`).
Both read rows by TMA, which needs 16-byte pitches: a shape with K % 8 or N
% 16 (or an unaligned base) runs on zero-padded copies (`_padded`).

`int8_matmul` is the entry point: a CPU tensor goes to `int8_matmul_plain`
(the XLA path of the JAX package's `_linear`); a CUDA tensor goes to the
rule's kernel, or raises on what the kernels do not take. `_launch` runs
one route by name (the tests and the chip smoke hold each route apart).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from . import _build
from .quant import quantize_int8
from .w8a16_stream import plan

launches = 0         # every K1 launch (the chip smoke reads it)
stream_launches = 0  # route "stream"
wgmma_launches = 0   # route "wgmma"

ROUTES = ("stream", "wgmma")
# rows at and below which the weight stream takes the product: it reads the
# weights once a 64-row m-block, so from two m-blocks on the wgmma route,
# which reads them once a 128- or 256-row block, is ahead (at M = 64 the two
# tie, at M = 1 the stream leads: PERF.md)
STREAM_MAX_M = 64
_COLS, _BK = 128, 64   # the wgmma route's block: output columns, k-tile
# the wgmma route's split rule: a 64-row k-tile of a 256-row block takes
# ~_KTILE_US on one SM (half that at 128 rows); a split writes and reads its
# f32 partials (8 bytes an output) at HBM speed and adds a launch of
# ~_SPLIT_US
_KTILE_US, _SPLIT_US, _HBM_B_PER_US = 0.9, 3.0, 3.35e6
_sms: dict[int, int] = {}


def quantize_weights_int8(w: torch.Tensor):
    """Per-output-channel weight quantization: (K, N) -> int8 (K, N) + f32
    scales (1, N)."""
    return quantize_int8(w, axis=0)


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


def pick_route(m: int, n: int, k: int) -> str:
    """The route that takes an (m, k) @ (k, n) product: the weight stream up
    to STREAM_MAX_M rows, wgmma above."""
    return "stream" if m <= STREAM_MAX_M else "wgmma"


def _rows(m: int) -> int:
    """Rows of x a block of the wgmma route: wgmma's N."""
    return 128 if m <= 128 else 256


@lru_cache(maxsize=256)
def _splits(m: int, n: int, k: int, sms: int) -> int:
    """K splits of the wgmma route: the fewest that minimise the modelled
    time, whole waves of (block, split) of ~k-tiles / splits k-tiles each
    plus the partials' traffic and the summing launch. Split z takes
    k-tiles [z * kt / s, (z + 1) * kt / s)."""
    rows = _rows(m)
    tiles = -(-m // rows) * -(-n // _COLS)
    kt = -(-k // _BK)
    best, best_s = None, 1
    for s in range(1, min(16, kt) + 1):
        waves = -(-tiles * s // sms)
        t = waves * -(-kt // s) * _KTILE_US * rows / 256
        if s > 1:
            t += s * 8 * m * n / _HBM_B_PER_US + _SPLIT_US
        if best is None or t < best:
            best, best_s = t, s
    return best_s


def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of `device` (one block of either route
    each)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _tma_ready(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> bool:
    """Rows of x and w_q are whole 16-byte vectors and every base is
    16-byte aligned, as TMA reads them."""
    return (x.shape[1] % 8 == 0 and w_q.shape[1] % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, w_q, scale)))


def _padded(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor):
    """Zero-padded copies with K a multiple of 8 and N of 16: the product's
    first N columns are unchanged (zero rows and columns add nothing)."""
    (m, k), n = x.shape, w_q.shape[1]
    kp, np_ = -(-k // 8) * 8, -(-n // 16) * 16
    xp = x.new_zeros((m, kp))
    xp[:, :k] = x
    wp = w_q.new_zeros((kp, np_))
    wp[:k, :n] = w_q
    sp = scale.new_zeros((np_,))
    sp[:n] = scale.reshape(-1)
    return xp, wp, sp


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                layer: int | None = None, out_dtype=None) -> torch.Tensor:
    """out = x @ (w_q * scale). x: (M, K); w_q: (K, N) int8 with scale (1, N)
    f32, or the full stacks (L, K, N) / (L, 1, N) with `layer` (a zero-copy
    view of that layer is handed to the kernel). The route is the rule's
    (`pick_route`). Returns (M, N)."""
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
    return _launch(pick_route(m, n, k), x, w_q, scale)


def _launch(route: str, x: torch.Tensor, w_q: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    """Route `route` (ROUTES) on operands `int8_matmul` has checked, 2-D
    and on the card: the tests and the chip smoke call it to hold each
    route against the plain version apart from the rule."""
    global launches, stream_launches, wgmma_launches
    if route not in ROUTES:
        raise ValueError(f"int8_matmul: route {route!r} is not one of "
                         f"{ROUTES}")
    m, k = x.shape
    n = w_q.shape[1]
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if not _tma_ready(x, w_q, scale):
        return _launch(route, *_padded(x, w_q, scale))[:, :n].contiguous()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    sms = num_sms(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "stream":
        pl = plan(m, n, k, sms)   # one block an SM
        ws = torch.empty((pl.partials, m, n), dtype=torch.float32,
                         device=x.device)
        err = _build.lib().pli_int8_matmul_stream(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            ws.data_ptr(), m, n, k, *pl.args(), stream)
    else:
        splits = _splits(m, n, k, sms)
        ws = (torch.empty((splits, m, n), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        err = _build.lib().pli_int8_matmul_wgmma(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, m, n, k, _rows(m),
            splits, stream)
    _build.check(err, f"int8_matmul ({route})")
    launches += 1
    if route == "stream":
        stream_launches += 1
    else:
        wgmma_launches += 1
    return out
