"""Grouped W8A16 expert products of an MoE decode step: the routed FFN's
(E, C, D) slot grid through every expert's INT8 SwiGLU stacks.

Replaces no TPU kernel: the JAX package computes the expert products
outside Pallas (`physics_llm_inference_tpu/models/moe.py`, einsums over
stacks dequantized into the compute dtype). The CUDA kernels are in
`csrc/moe_experts.cu`: the weight stream of `csrc/w8a16_stream.cuh` over
all experts' stacks in one stream-K launch (`w8a16_stream.plan` with the
expert as the m-block), bound by the expert weight bytes (1.409 GB a layer
at Mixtral's widths), each read once; no bf16 copy of a stack is made. Two
launches a call, each counted in `launches`: w1 and w3 together, their f32
sums scaled and joined by silu(h1) * h3 into the bf16 hidden grid, then w2
over it. Only routed slots are worked on: with `counts` (E,) int64, expert
e's live rows are slot rows 0..min(counts[e], C)-1 (the routed FFN claims
them in that order), and the kernels load, multiply, store and sum those
alone, in 16-row tiles; a dead row of the output is +0, whatever its slot
held. `tile_counter` keeps, per device, the m16 slot tiles the gate/up
launches worked on beside all of them.

`moe_experts` is the entry point: a CPU tensor goes to
`moe_experts_plain`, which repeats the kernels' arithmetic (f32 products of
the bf16 slots with the int8 values, scales on the f32 sums, SwiGLU in f32,
one rounding to bf16 each launch); a CUDA tensor goes to the kernels, or
raises on what they do not take. The routed FFN (`models/moe._routed`)
takes them where its slots and stacks fit them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .int8_matmul import num_sms
from .w8a16_stream import MT, SLAB, plan

launches = 0   # kernel launches: two a moe_experts call on the card

# an expert's slots must fit the stream's one m-block of rows
MAX_SLOTS = MT
TILE = 16      # slot rows an m16 tile

# device -> (2,) int64: [live m16 slot tiles, all of them], summed over the
# gate/up launches since the caller last zeroed it
_tiles: dict[torch.device, torch.Tensor] = {}


def tile_counter(device) -> torch.Tensor | None:
    """The (2,) int64 tile count on `device`, [sum over calls and experts of
    ceil(n_e / 16), E * ceil(C / 16) a call], n_e the expert's live rows;
    None until a call with counts ran there outside a graph capture. The
    caller zeroes it; the kernel adds to it on every replay."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _tiles.get(device)


def _counter(device: torch.device) -> torch.Tensor | None:
    """`device`'s tile count, made at its first use (not while a graph is
    captured: it would live in the graph's memory; that call counts
    nothing)."""
    tiles = _tiles.get(device)
    if tiles is None and not (device.type == "cuda"
                              and torch.cuda.is_current_stream_capturing()):
        tiles = _tiles[device] = torch.zeros(2, dtype=torch.int64,
                                             device=device)
    return tiles


def moe_experts_plain(x: torch.Tensor, w1, w3, w2,
                      counts: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch: x (E, C, D) slot grid; w1, w3 QuantizedTensors (q (E, D,
    F) int8, s (E, 1, F) f32), w2 (q (E, F, D), s (E, 1, D)). h = x @ q in
    f32 (the int8 values exact), times the column's scale; hidden =
    silu(h1) * h3 in f32, rounded once to x's dtype; out = (hidden @ q2) *
    s2 in f32, rounded once. With `counts` (E,), rows from min(counts[e], C)
    of expert e are +0. Returns (E, C, D)."""
    xf = x.float()
    h1 = torch.bmm(xf, w1.q.float()) * w1.s
    h3 = torch.bmm(xf, w3.q.float()) * w3.s
    hidden = (F.silu(h1) * h3).to(x.dtype)
    out = (torch.bmm(hidden.float(), w2.q.float()) * w2.s).to(x.dtype)
    if counts is None:
        return out
    live = torch.arange(x.shape[1], device=x.device) < counts[:, None]
    return torch.where(live[..., None], out, out.new_zeros(()))


def moe_experts(x: torch.Tensor, w1, w3, w2,
                counts: torch.Tensor | None = None) -> torch.Tensor:
    """The expert products of `moe_experts_plain`, on the kernels for a
    CUDA tensor (two launches). `counts` (E,) int64 on x's device: each
    expert's routed pairs (clamped to [0, C] here); None: every slot is
    live. Returns (E, C, D) bf16, dead rows +0."""
    e, c, d = x.shape
    if counts is not None and (counts.dtype != torch.int64
                               or tuple(counts.shape) != (e,)
                               or counts.device != x.device):
        raise ValueError(f"moe_experts: counts must be int64 ({e},) on "
                         f"{x.device}")
    if not x.is_cuda:
        if counts is not None:
            tiles = _counter(x.device)
            tiles[0] += (counts.clamp(0, c) + TILE - 1).div(
                TILE, rounding_mode="floor").sum()
            tiles[1] += e * -(-c // TILE)
        return moe_experts_plain(x, w1, w3, w2, counts)
    f = w1.q.shape[-1]
    want = {"w1": (w1, (e, d, f)), "w3": (w3, (e, d, f)),
            "w2": (w2, (e, f, d))}
    if x.dtype != torch.bfloat16:
        raise TypeError("moe_experts on CUDA takes bf16 slots")
    if c > MAX_SLOTS or d % 16 or f % 16:
        raise ValueError(f"moe_experts takes at most {MAX_SLOTS} slots an "
                         f"expert and widths of 16: x {tuple(x.shape)}, F {f}")
    for name, (w, shape) in want.items():
        if (tuple(w.q.shape) != shape or w.q.dtype != torch.int8
                or tuple(w.s.shape) != (e, 1, shape[-1])
                or w.s.dtype != torch.float32):
            raise ValueError(f"moe_experts: {name} is not int8 {shape} with "
                             f"f32 scales {(e, 1, shape[-1])}")
    for t in (x, *(p for w, _ in want.values() for p in w)):
        if (t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("moe_experts needs contiguous 16-byte aligned "
                             "tensors on one device")
    counts = (torch.full((e,), c, dtype=torch.int64, device=x.device)
              if counts is None else counts.contiguous())
    hidden = torch.empty((e, c, f), dtype=torch.bfloat16, device=x.device)
    _stream(x, (w1, w3), hidden, counts, _counter(x.device))
    out = torch.empty((e, c, d), dtype=torch.bfloat16, device=x.device)
    _stream(hidden, (w2,), out, counts)
    return out


def _stream(x: torch.Tensor, stacks, out: torch.Tensor, counts: torch.Tensor,
            tiles: torch.Tensor | None = None) -> None:
    """One grouped launch: x (E, C, K) against the one or two stacks'
    (E, K, N) weights into out (E, C, N), for each expert's live rows
    (`counts`), its f32 partials in a workspace sized by the plan; block 0
    adds the tiles to `tiles` where one is given."""
    global launches
    e, c, k = x.shape
    n = stacks[0].q.shape[-1]
    pl = plan(e * MT, len(stacks) * -(-n // SLAB) * SLAB, k,
              num_sms(x.device))
    ws = torch.empty((pl.partials, e * c, len(stacks) * n),
                     dtype=torch.float32, device=x.device)
    a, b = stacks[0], stacks[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.lib().pli_moe_expert_stream(
        x.data_ptr(), a.q.data_ptr(), a.s.data_ptr(), b.q.data_ptr(),
        b.s.data_ptr(), out.data_ptr(), ws.data_ptr(), counts.data_ptr(),
        0 if tiles is None else tiles.data_ptr(), e, c, k, n, len(stacks),
        *pl.args(), stream)
    _build.check(err, "moe_experts")
    launches += 1
