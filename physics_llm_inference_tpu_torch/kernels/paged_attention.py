"""K6 and K7: one-query decode attention over paged KV pools, and the paged
pool writes.

K6 `int8_paged_decode_attention` replaces the TPU kernel
`physics_llm_inference_tpu/kernels/paged_attention.py`
`int8_paged_decode_attention` (`_int8_paged_kernel`): the merged INT8 pools,
values (L, NB, 2, BS, Hkv·d) int8 with each block's K page at index 0 and V
page at index 1 of axis 2, scales (L, NB, 2, Hkv, BS) f32. K7
`paged_decode_attention` replaces `paged_decode_attention` (`_paged_kernel`):
plain pools (L, NB, BS, Hkv, d) or (NB, BS, Hkv, d). Both CUDA kernels are
in `csrc/paged_attention.cu`: bound by the live KV bytes, one block per (kv
head, request) walks the request's keys [0, context_lens[b]) through its
row of the block table, so dead blocks are never read. K6 runs the attention
loop that K2, K4 and K8 share (`csrc/int8_kv_attention.cuh`) with a paged
addressor; K7 stages bf16 rows in its own loop.

Numerics are the TPU kernels': K6 multiplies bf16 q by the bare int8 keys
in f32, scales the scores by k_scale / sqrt(d), and rounds p * v_scale to
bf16 before P@V; K7 is f32 throughout. A row with no live key returns 0.
Contexts past the table (MB·BS keys) stop there, and a table column past
the table is clamped to MB - 1, as JAX clamps its gathers.

`int8_paged_decode_attention` and `paged_decode_attention` are the entry
points: a CPU tensor goes to the plain twin; a CUDA tensor goes to the
kernel or raises. The pool writes (`write_position`, `paged_write`,
`paged_write_prefill`) are plain scatters, as in the JAX package; they
update the pools IN PLACE and return them.
"""
from __future__ import annotations

import math

import torch

from . import _build

int8_paged_launches = 0  # kernel launches made by int8_paged_decode_attention
paged_launches = 0       # kernel launches made by paged_decode_attention

_NEG_INF = -1e30
_DMAX, _GMAX = 128, 8  # the kernels' head_dim and group limits


def _softmax_out(s, live, v, pscale=None, round_p=False):
    """Masked softmax of scores s (B, Hkv, g, S) over the live keys (B, S),
    then P @ v (B, S, Hkv, d) divided by the row sum where it is > 0, else
    by 1 (a row with no live key gives 0). pscale (B, Hkv, S) multiplies p
    before P@V; round_p rounds that product to bf16."""
    mask = live[:, None, None, :]
    s = s.masked_fill(~mask, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if pscale is not None:
        p = p * pscale[:, :, None, :]
    if round_p:
        p = p.to(torch.bfloat16).float()
    o = torch.einsum("bhgs,bshd->bhgd", p, v)
    return o / torch.where(l > 0, l, torch.ones_like(l))


def int8_paged_decode_attention_plain(q, kv_pool, kvs_pool, block_tables,
                                      context_lens, layer=None):
    """Plain torch with `_int8_paged_kernel`'s numerics
    (paged_attention.py:180-219), every request's blocks gathered at once."""
    if kv_pool.dim() == 4:
        kv_pool, kvs_pool, layer = kv_pool[None], kvs_pool[None], 0
    if layer is None:
        raise ValueError("stacked pools need a layer index")
    kv, kvs = kv_pool[layer], kvs_pool[layer]
    b, hq, d = q.shape
    _, _, bs, flat = kv.shape
    hkv = kvs.shape[-2]
    t = block_tables.long()
    cap = t.shape[1] * bs
    k = kv.select(1, 0)[t].reshape(b, cap, hkv, d).float()
    v = kv.select(1, 1)[t].reshape(b, cap, hkv, d).float()
    # (B, MB, Hkv, BS) -> (B, Hkv, MB·BS)
    ks = kvs.select(1, 0)[t].transpose(1, 2).reshape(b, hkv, cap)
    vs = kvs.select(1, 1)[t].transpose(1, 2).reshape(b, hkv, cap)
    qg = q.to(torch.bfloat16).float().reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k)
    s = s * (ks * (1.0 / math.sqrt(d)))[:, :, None, :]
    live = (torch.arange(cap, device=q.device)[None, :]
            < context_lens.reshape(b, 1).long())
    o = _softmax_out(s, live, v, pscale=vs, round_p=True)
    return o.reshape(b, hq, d).to(q.dtype)


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                 context_lens, layer=None):
    """Plain torch with `_paged_kernel`'s numerics (paged_attention.py:
    47-77): everything in f32."""
    if k_pool.dim() == 5:
        if layer is None:
            raise ValueError("stacked pools need a layer index")
        k_pool, v_pool = k_pool[layer], v_pool[layer]
    b, hq, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    t = block_tables.long()
    cap = t.shape[1] * bs
    k = k_pool[t].reshape(b, cap, hkv, d).float()
    v = v_pool[t].reshape(b, cap, hkv, d).float()
    qg = q.float().reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * (1.0 / math.sqrt(d))
    live = (torch.arange(cap, device=q.device)[None, :]
            < context_lens.reshape(b, 1).long())
    return _softmax_out(s, live, v).reshape(b, hq, d).to(q.dtype)


def _launch_args(q, tables, lens, pools):
    """Checks shared by K6 and K7; returns (tables, lens) as contiguous
    int32 and the output tensor."""
    b, hq, d = q.shape
    tbl = tables.to(torch.int32).contiguous()
    ln = lens.reshape(-1).to(torch.int32).contiguous()
    if tbl.dim() != 2 or tbl.shape[0] != b or ln.shape[0] != b:
        raise ValueError(f"block tables {tuple(tables.shape)} and lengths "
                         f"{tuple(lens.shape)} do not match batch {b}")
    if q.dtype != torch.bfloat16:
        raise TypeError("the paged attention kernels take bf16 queries")
    for t in (q, tbl, ln, *pools):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("kernel needs contiguous tensors on one device")
    if any(p.data_ptr() % 16 for p in pools):
        raise ValueError("pool rows must be 16-byte aligned")
    return tbl, ln, torch.empty_like(q)


def int8_paged_decode_attention(q, kv_pool, kvs_pool, block_tables,
                                context_lens, layer=None):
    """q: (B, Hq, d); kv_pool: (L, NB, 2, BS, Hkv·d) int8 with `layer`, or
    one layer (NB, 2, BS, Hkv·d); kvs_pool: (…, NB, 2, Hkv, BS) f32;
    block_tables: (B, MB) block ids < NB; context_lens: (B,) keys per
    request (the current token included). Returns (B, Hq, d)."""
    global int8_paged_launches
    if not q.is_cuda:
        return int8_paged_decode_attention_plain(q, kv_pool, kvs_pool,
                                                 block_tables, context_lens,
                                                 layer)
    if kv_pool.dim() == 5:
        if layer is None:
            raise ValueError("stacked pools need a layer index")
        kv_pool, kvs_pool = kv_pool[int(layer)], kvs_pool[int(layer)]
    b, hq, d = q.shape
    nb, two, bs, flat = kv_pool.shape
    hkv = kvs_pool.shape[-2]
    if (two != 2 or flat != hkv * d or hq % hkv
            or tuple(kvs_pool.shape) != (nb, 2, hkv, bs)):
        raise ValueError("int8_paged_decode_attention: inconsistent shapes "
                         f"q {tuple(q.shape)}, kv {tuple(kv_pool.shape)}, "
                         f"kvs {tuple(kvs_pool.shape)}")
    if d % 16 or d > _DMAX or hq // hkv > _GMAX:
        raise ValueError(f"kernel takes head_dim % 16 == 0, <= {_DMAX} and "
                         f"<= {_GMAX} query heads per kv head")
    if kv_pool.dtype != torch.int8 or kvs_pool.dtype != torch.float32:
        raise TypeError("kernel takes int8 pools and f32 scales")
    tbl, ln, out = _launch_args(q, block_tables, context_lens,
                                (kv_pool, kvs_pool))
    if b == 0:
        return out
    err = _build.lib().pli_int8_paged_decode_attention(
        q.data_ptr(), kv_pool.data_ptr(), kvs_pool.data_ptr(), tbl.data_ptr(),
        ln.data_ptr(), out.data_ptr(), b, tbl.shape[1], bs, hq, hkv, d,
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "int8_paged_decode_attention")
    int8_paged_launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, context_lens,
                           layer=None):
    """q: (B, Hq, d); k_pool/v_pool: (NB, BS, Hkv, d), or the stack
    (L, NB, BS, Hkv, d) with `layer`; block_tables: (B, MB) block ids < NB;
    context_lens: (B,) keys per request. Returns (B, Hq, d). On CUDA the
    pools are bf16."""
    global paged_launches
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            context_lens, layer)
    if k_pool.dim() == 5:
        if layer is None:
            raise ValueError("stacked pools need a layer index")
        k_pool, v_pool = k_pool[int(layer)], v_pool[int(layer)]
    b, hq, d = q.shape
    _, bs, hkv, _ = k_pool.shape
    if (v_pool.shape != k_pool.shape or k_pool.shape[-1] != d or hkv == 0
            or hq % hkv):
        raise ValueError("paged_decode_attention: inconsistent shapes "
                         f"q {tuple(q.shape)}, k {tuple(k_pool.shape)}, "
                         f"v {tuple(v_pool.shape)}")
    if d % 8 or d > _DMAX or hq // hkv > _GMAX:
        raise ValueError(f"kernel takes head_dim % 8 == 0, <= {_DMAX} and "
                         f"<= {_GMAX} query heads per kv head")
    if k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16:
        raise TypeError("paged_decode_attention on CUDA takes bf16 pools")
    tbl, ln, out = _launch_args(q, block_tables, context_lens,
                                (k_pool, v_pool))
    if b == 0:
        return out
    err = _build.lib().pli_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tbl.data_ptr(),
        ln.data_ptr(), out.data_ptr(), b, tbl.shape[1], bs, hq, hkv, d,
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    paged_launches += 1
    return out


def write_position(tables, lengths, block_size: int):
    """(block ids, offsets) (B,) of each request's current token:
    tables[b, lengths[b] // block_size], lengths[b] % block_size. The column
    is clamped to MB - 1 as JAX clamps the gather, so a stale length past
    the table (a retired row inside a decode horizon) writes inside its own
    table row and never into the next one's."""
    lens = lengths.reshape(-1).long()
    col = (lens // block_size).clamp(max=tables.shape[1] - 1)
    blk = tables.long().gather(1, col[:, None])[:, 0]
    return blk, lens % block_size


def paged_write(k_pool, v_pool, k_new, v_new, block_ids, offsets):
    """Scatter this step's K/V (B, Hkv, d) into the pools (NB, BS, Hkv, d)
    at (block_ids, offsets) (B,), in place. Returns the pools."""
    b, o = block_ids.long(), offsets.long()
    k_pool[b, o] = k_new.to(k_pool.dtype)
    v_pool[b, o] = v_new.to(v_pool.dtype)
    return k_pool, v_pool


def paged_write_prefill(k_pool, v_pool, k_seq, v_seq, table, length: int):
    """Scatter one request's prefilled K/V (S, Hkv, d) into the pools
    through its table (MB,), in place. Only positions < length are written:
    JAX routes the padding past the pool and drops it; here it is never
    selected. Returns the pools."""
    bs = k_pool.shape[1]
    n = min(int(length), k_seq.shape[0])
    pos = torch.arange(n, device=k_seq.device)
    col = (pos // bs).clamp(max=table.shape[0] - 1)
    blk = table.long()[col]
    k_pool[blk, pos % bs] = k_seq[:n].to(k_pool.dtype)
    v_pool[blk, pos % bs] = v_seq[:n].to(v_pool.dtype)
    return k_pool, v_pool
