"""MLA decode attention: the absorbed form of multi-head latent attention
over the INT8 latent cache (models/mla.py).

Replaces no TPU kernel: the JAX package has no latent attention. The CUDA
kernels are `csrc/mla_decode.cu`: one block per (run of keys, request)
reads the live latent rows [valid_from, q_slot] of its run once, all 16
query heads against one 576-wide head (512 latent + 64 rope dims), both
products on mma.sync with the int8 codes widened to bf16 in shared
memory; a second launch merges the runs. Bound by the live cache bytes
(584 a key and layer).

`mla_decode_attention` is the entry point: a CPU tensor goes to
`mla_decode_attention_plain`; a CUDA tensor goes to the kernels, or raises
on a shape they do not take.
"""
from __future__ import annotations

import torch

from . import _build
from .int8_matmul import num_sms

launches = 0   # calls of the kernels on the card (two launches each)

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
HEADS, RANK, ROPE = 16, 512, 64   # the kernel's shape
TILE = 64                          # keys a tile


def mla_decode_attention_plain(q, codes, scales, q_slot, valid_from, scale,
                               rank: int = RANK):
    """Plain torch: q (B, H, rank + dr) absorbed queries; codes (B, S,
    rank + dr) int8 and scales (B, 2, S) f32 of one layer's latent cache.
    Dequantize in f32, scores of the latent and the rope key, masked to
    [valid_from, q_slot], an f32 softmax, the f32 product with the
    latent. Returns (B, H, rank) in q's dtype."""
    b, _, _ = q.shape
    s = codes.shape[1]
    cf = codes.float()
    lat = cf[..., :rank] * scales[:, 0, :, None]
    pe = cf[..., rank:] * scales[:, 1, :, None]
    qf = q.float()
    sc = (torch.einsum("bhr,bsr->bhs", qf[..., :rank], lat)
          + torch.einsum("bhd,bsd->bhs", qf[..., rank:], pe)) * scale
    kpos = torch.arange(s, device=q.device)
    qslot = q_slot.reshape(b).long()
    vfrom = (torch.zeros_like(qslot) if valid_from is None
             else valid_from.reshape(b).long())
    mask = (kpos[None, :] <= qslot[:, None]) & \
        (kpos[None, :] >= vfrom[:, None])
    sc = sc.masked_fill(~mask[:, None, :], _NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhs,bsr->bhr", p, lat).to(q.dtype)


def splits_for(b: int, s: int, device) -> int:
    """Runs a request's keys are cut into: about four blocks an SM over the
    batch, and no run shorter than four tiles of the cache's capacity."""
    want = -(-4 * num_sms(device) // b)
    return max(1, min(want, -(-s // (4 * TILE))))


def mla_decode_attention(q, codes, scales, q_slot, valid_from, scale,
                         rank: int = RANK):
    """q: (B, H, rank + dr); codes: (B, S, rank + dr) int8; scales: (B, 2,
    S) f32; q_slot: (B,) last attendable slot; valid_from: (B,) first
    valid slot, or None; scale: the softmax scale. Returns (B, H, rank)."""
    global launches
    if not q.is_cuda:
        return mla_decode_attention_plain(q, codes, scales, q_slot,
                                          valid_from, scale, rank)
    b, h, w = q.shape
    s = codes.shape[1]
    if (h, rank, w) != (HEADS, RANK, RANK + ROPE) or \
            codes.shape != (b, s, w) or scales.shape != (b, 2, s):
        raise ValueError(f"mla_decode takes {HEADS} heads of a {RANK} + "
                         f"{ROPE} latent: q {tuple(q.shape)}, codes "
                         f"{tuple(codes.shape)}, scales {tuple(scales.shape)}")
    if q.dtype != torch.bfloat16 or codes.dtype != torch.int8 \
            or scales.dtype != torch.float32:
        raise TypeError("mla_decode takes bf16 q, int8 codes, f32 scales")
    qslot = q_slot.reshape(b).to(torch.int32).contiguous()
    vfrom = (torch.zeros_like(qslot) if valid_from is None
             else valid_from.reshape(b).to(torch.int32).contiguous())
    for t in (q, codes, scales, qslot, vfrom):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("mla_decode needs contiguous tensors on one "
                             "device")
    if q.data_ptr() % 16 or codes.data_ptr() % 16:
        raise ValueError("mla_decode reads q and the codes by 16 bytes: "
                         "their bases must be 16-byte aligned")
    splits = splits_for(b, s, q.device)
    out = torch.empty((b, h, rank), dtype=torch.bfloat16, device=q.device)
    ws_o = torch.empty((b, splits, h, rank), dtype=torch.float32,
                       device=q.device)
    ws_ml = torch.empty((b, splits, h, 2), dtype=torch.float32,
                        device=q.device)
    err = _build.lib().pli_mla_decode(
        q.data_ptr(), codes.data_ptr(), scales.data_ptr(), qslot.data_ptr(),
        vfrom.data_ptr(), out.data_ptr(), ws_o.data_ptr(), ws_ml.data_ptr(),
        b, s, splits, scale * _LOG2E,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mla_decode")
    launches += 1
    return out
