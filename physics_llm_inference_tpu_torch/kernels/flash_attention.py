"""K5: causal GQA flash attention for prefill.

Replaces the TPU kernel `physics_llm_inference_tpu/kernels/
flash_attention.py` `flash_attention` (`_flash_kernel_v3` +
`_flash_finalize`). The CUDA kernel is `csrc/flash_attention.cu`, in
FlashAttention-2's form: one block of 8 warps per (q tile, kv head,
request) holds the whole GQA group's 128 rows, so each K/V tile in shared
memory feeds every head of the group; K/V tiles of 32 keys stream through a
two-stage `cp.async` ring; scores, probabilities and the output stay in
registers (`mma.sync` m16n8k16 bf16, f32 accumulation, a base-2 f32 online
softmax); it walks only the live KV tiles, from the one holding
`valid_from` to the causal last one. Ragged lengths are masked in the
kernel, so no length needs to divide a tile. Head widths of 16 to 128 run
with q, k and v alike; multi-head latent attention's prefill (models/
mla.py) runs q and k of 192 against v of 128 (one more instance).

`flash_attention` is the entry point: a CPU tensor goes to
`flash_attention_plain`; a CUDA tensor goes to the kernel or raises.
"""
from __future__ import annotations

import math

import torch

from . import _build

launches = 0  # kernel launches made by flash_attention

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_DMAX, _GMAX = 128, 64  # the kernel's head_dim and group limits
_MLA_DIMS = (192, 128)  # the one instance with q/k and v of their own widths


def _per_request(val, b: int, device) -> torch.Tensor:
    """A scalar or (B,) int -> a contiguous (B,) int32 tensor on `device`.
    A scalar is filled on the device: a host-to-device copy from pageable
    memory would hold the host until the stream reaches it."""
    if not isinstance(val, torch.Tensor):
        val = torch.as_tensor(val)
        if val.numel() == 1:
            return torch.full((b,), int(val), dtype=torch.int32, device=device)
    return val.to(device=device, dtype=torch.int32).reshape(-1).expand(b) \
        .contiguous()


def flash_attention_plain(q, k, v, q_offset=0, causal=True, kv_len=None,
                          valid_from=None, scale=None):
    """Plain torch: the kernel's arithmetic in one pass — products of the
    input-dtype operands in f32, the scale with log2(e) folded in, masked
    scores at -1e30, a base-2 f32 softmax, probabilities cast to v's dtype
    before P@V, output in q's dtype. A row with no live key averages over
    masked keys, as the TPU kernel does; only live rows are specified."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qoff = _per_request(q_offset, b, q.device).long()
    kpos = torch.arange(sk, device=q.device)
    mask = kpos[None, None, :] < (sk if kv_len is None else kv_len)
    if causal:
        qpos = qoff[:, None] + torch.arange(sq, device=q.device)[None, :]
        mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
    if valid_from is not None:
        vfrom = _per_request(valid_from, b, q.device).long()
        mask = mask & (kpos[None, None, :] >= vfrom[:, None, None])
    qg = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    s = s * (scale * _LOG2E)
    s = s.masked_fill(~mask.expand(b, sq, sk)[:, None, None], _NEG_INF)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    o = o / p.sum(dim=-1, keepdim=True)
    return o.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def flash_attention(q, k, v, q_offset=0, causal=True, kv_len=None,
                    valid_from=None, scale=None):
    """q: (B, Hq, Sq, d); k: (B, Hkv, Sk, d); v: (B, Hkv, Sk, dv), any
    strides with a contiguous last axis. q_offset: the key position of
    q[:, :, 0], scalar or (B,); kv_len: valid key prefix (<= Sk);
    valid_from: (B,) first valid key (left padding); scale: the softmax
    scale (default d**-0.5). Returns (B, Hq, Sq, dv) in q's dtype."""
    global launches
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, q_offset, causal, kv_len,
                                     valid_from, scale)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    dv = v.shape[-1]
    if (k.shape != (b, hkv, sk, d) or v.shape != (b, hkv, sk, dv)
            or hkv == 0 or hq % hkv):
        raise ValueError(f"flash_attention: inconsistent shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if (d, dv) != _MLA_DIMS and (d % 16 or d > _DMAX or dv != d) \
            or hq // hkv > _GMAX:
        raise ValueError(f"kernel takes head_dim % 16 == 0, <= {_DMAX} "
                         f"(v alike), or q/k {_MLA_DIMS[0]} with v "
                         f"{_MLA_DIMS[1]}, and <= {_GMAX} query heads per "
                         f"kv head")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("flash_attention on CUDA takes bf16 q, k and v")
    kv_len = sk if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len {kv_len} outside [0, {sk}]")
    for t in (q, k, v):
        if t.device != q.device or t.stride(-1) != 1 \
                or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError("kernel needs tensors on one device with a "
                             "contiguous last axis and 16-byte aligned rows")
    qoff = _per_request(q_offset, b, q.device)
    vfrom = _per_request(0 if valid_from is None else valid_from, b, q.device)
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    err = _build.lib().pli_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        qoff.data_ptr(), vfrom.data_ptr(), b, hq, hkv, sq, sk, d, dv, kv_len,
        int(causal), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        (1.0 / math.sqrt(d) if scale is None else scale) * _LOG2E,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out
