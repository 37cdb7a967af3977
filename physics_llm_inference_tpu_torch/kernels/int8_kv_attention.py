"""K2: one-query GQA decode attention over the INT8 KV cache.

Replaces the TPU kernel `physics_llm_inference_tpu/kernels/
int8_kv_attention.py` `int8_kv_decode_attention` (`_kernel`). The CUDA
kernel is `csrc/int8_kv_attention.cu`: bound by the int8 KV bytes, one block
per (kv head, request) reads only the live slots [valid_from, q_slot] of its
cache row, applies the k-scale to scores and the v-scale to probabilities
(K and V stay bare int8), and keeps an f32 online softmax.

Cache layout (runtime/kv_cache.py QuantKV): values flat (…, S, Hkv·d) int8,
scales transposed (…, Hkv, S) f32; stacked (L, B, …) with a `layer` index,
whose zero-copy view is handed to the kernel.

`int8_kv_decode_attention` is the entry point: a CPU tensor goes to
`int8_kv_decode_attention_plain` (the JAX package's `_dense_fallback`); a
CUDA tensor goes to the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from . import _build

launches = 0  # kernel launches made by int8_kv_decode_attention

_NEG_INF = -1e30
_DMAX, _GMAX = 128, 8  # the kernel's head_dim and group limits


def _layer_view(k_q, k_s, v_q, v_s, layer):
    if k_q.dim() == 4:
        if layer is None:
            raise ValueError("stacked caches need a layer index")
        return k_q[layer], k_s[layer], v_q[layer], v_s[layer]
    return k_q, k_s, v_q, v_s


def int8_kv_decode_attention_plain(q, k_q, k_s, v_q, v_s, q_slot,
                                   valid_from=None, layer=None):
    """Plain torch (`_dense_fallback`, int8_kv_attention.py:129-143): dequantize
    K/V in f32, masked softmax over every slot, f32 P@V, cast to q's dtype."""
    k_q, k_s, v_q, v_s = _layer_view(k_q, k_s, v_q, v_s, layer)
    b, hq, d = q.shape
    s = k_q.shape[1]
    hkv = k_s.shape[-2]
    group = hq // hkv
    k = k_q.reshape(b, s, hkv, d).float() * k_s.transpose(1, 2)[..., None]
    v = v_q.reshape(b, s, hkv, d).float() * v_s.transpose(1, 2)[..., None]
    qg = q.float().reshape(b, hkv, group, d)
    sc = torch.einsum("bhgd,bshd->bhgs", qg, k) * (1.0 / math.sqrt(d))
    kpos = torch.arange(s, device=q.device)
    qslot = q_slot.reshape(b).to(kpos.dtype)
    vfrom = (torch.zeros_like(qslot) if valid_from is None
             else valid_from.reshape(b).to(kpos.dtype))
    mask = (kpos[None, :] <= qslot[:, None]) & (kpos[None, :] >= vfrom[:, None])
    sc = sc.masked_fill(~mask[:, None, None, :], _NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(b, hq, d).to(q.dtype)


def int8_kv_decode_attention(q, k_q, k_s, v_q, v_s, q_slot, valid_from=None,
                             layer=None):
    """q: (B, Hq, d); k_q/v_q: flat int8 (B, S, Hkv·d) or (L, B, S, Hkv·d)
    with `layer`; k_s/v_s: (…, Hkv, S) f32; q_slot: (B,) last attendable slot;
    valid_from: (B,) first valid slot (left padding). Returns (B, Hq, d)."""
    global launches
    if not q.is_cuda:
        return int8_kv_decode_attention_plain(q, k_q, k_s, v_q, v_s, q_slot,
                                              valid_from, layer)
    k_q, k_s, v_q, v_s = _layer_view(k_q, k_s, v_q, v_s, layer)
    b, hq, d = q.shape
    _, s, flat = k_q.shape
    hkv = k_s.shape[-2]
    if (flat != hkv * d or hq % hkv or k_s.shape != (b, hkv, s)
            or v_q.shape != k_q.shape or v_s.shape != k_s.shape
            or k_q.shape[0] != b):
        raise ValueError("int8_kv_decode_attention: inconsistent shapes "
                         f"q {tuple(q.shape)}, k_q {tuple(k_q.shape)}, "
                         f"k_s {tuple(k_s.shape)}")
    if d % 16 or d > _DMAX or hq // hkv > _GMAX:
        raise ValueError(f"kernel takes head_dim % 16 == 0, <= {_DMAX} and "
                         f"<= {_GMAX} query heads per kv head")
    if q.dtype != torch.bfloat16 or k_q.dtype != torch.int8 \
            or v_q.dtype != torch.int8 or k_s.dtype != torch.float32 \
            or v_s.dtype != torch.float32:
        raise TypeError("kernel takes bf16 q, int8 K/V and f32 scales")
    qslot = q_slot.reshape(b).to(torch.int32).contiguous()
    vfrom = (torch.zeros_like(qslot) if valid_from is None
             else valid_from.reshape(b).to(torch.int32).contiguous())
    for t in (q, k_q, k_s, v_q, v_s, qslot, vfrom):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("kernel needs contiguous tensors on one device")
    if k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError("int8 cache rows must be 16-byte aligned")
    out = torch.empty_like(q)
    err = _build.lib().pli_int8_kv_decode_attention(
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
        v_s.data_ptr(), qslot.data_ptr(), vfrom.data_ptr(), out.data_ptr(),
        b, s, hq, hkv, d, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "int8_kv_decode_attention")
    launches += 1
    return out
