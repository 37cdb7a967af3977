"""Paged-KV transformer step functions (counterpart:
physics_llm_inference_tpu/models/paged_transformer.py).

The model side of paged serving: KV lives in per-layer block pools managed
by runtime/paged_kv.py block tables. Plain pools are (L, NB, BS, Hkv, hd);
INT8 pools are MERGED, `QuantKV(q=(L, NB, 2, BS, Hkv·hd) int8,
s=(L, NB, 2, Hkv, BS) f32)` with each block's K page at index 0 and V page
at index 1 of axis 2, and no separate V pools (v_pools is None).

What differs from the JAX package, on purpose:
- The pools are updated IN PLACE and returned (JAX rebuilds them and
  aliases them under jit); the layer loop is a Python loop.
- JAX clamps out-of-range gathers and drops out-of-range scatters; torch
  raises on the CPU and faults on CUDA. So a table column past the table is
  clamped to MB - 1 (`write_position`), a RoPE position past the table to
  max_seq_len - 1 (stale lengths of retired rows inside a decode horizon
  reach both), and the K/V writes of prefill padding are routed to the
  trash block (the pool's last block) where JAX routes them past the pool
  and drops them: no host sync picks the real tokens out, so a prefill
  chunk can be captured in a CUDA graph.
- On a CUDA tensor a decode step that passes the reference's fused gate
  runs K8 `fused_paged_decode_step` (one launch for every layer, pools
  written in place); the others take the per-op path with K1 linears and
  K6 (INT8 pools) or K7 (bf16 pools) attention. Every prefill chunk runs K5
  `flash_attention` over the request's gathered MB·BS prefix. On a CPU
  tensor the gate is false, as on the JAX CPU backend, and every kernel
  takes its plain twin.
- An MoE config runs the routed FFN (models/moe.py) in both steps, with no
  `valid` mask, as in the JAX package: a padded row of a prefill chunk and
  an inactive decode row route like real ones. Its decode never passes
  the fused gate (K8 has no MoE mode), so it runs K6 or K7.
- Tensor parallelism raises NotImplementedError, as `forward` does.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.fused_decode import (fused_paged_decode_ok,
                                    fused_paged_decode_step)
from ..kernels.paged_attention import (int8_paged_decode_attention,
                                       paged_decode_attention, write_position)
from ..kernels.quant import quantize_int8
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_frequencies
from ..ops.sampling import sample_token
from .config import ModelConfig
from .quant import QuantizedTensor
from .transformer import (QuantKV, _ffn, _linear, embed_lookup, layer_view,
                          lm_logits)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.tp_axis is not None:
        raise NotImplementedError("tensor parallelism is not ported yet "
                                  "(ROADMAP Queue A)")


def _rope_tables(cfg: ModelConfig, device):
    if not cfg.use_rope:
        return None, None
    return rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                            device=device)


def _rope_positions(positions: torch.Tensor, cfg: ModelConfig):
    """Positions for the RoPE table gather, clamped as JAX clamps it."""
    return positions.clamp(max=cfg.max_seq_len - 1)


def _paged_fused_ok(params: dict, cfg: ModelConfig, b: int, k_pools,
                    tables) -> bool:
    """The reference's gate for the fused paged decode kernel
    (paged_transformer.py:38-67), with "the backend is a TPU" read as "the
    pools are on CUDA". The reference's FUSED_PAGED=0 opt-out is left out:
    where the gate passes on CUDA, K8 runs."""
    if not (cfg.fused_decode and cfg.use_rope
            and cfg.attention_impl != "dense" and cfg.tp_axis is None):
        return False
    if not (isinstance(k_pools, QuantKV) and k_pools.q.dim() == 5
            and k_pools.q.is_cuda):
        return False
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        w = params["blocks"].get(name)
        if not (isinstance(w, QuantizedTensor) and w.q.dim() == 3):
            return False
    return fused_paged_decode_ok(cfg, b, tables.shape[1], k_pools.q.shape[3],
                                 NB=k_pools.q.shape[1])


def _paged_decode_step_impl(params: dict, tokens: torch.Tensor, k_pools,
                            v_pools, tables: torch.Tensor,
                            lengths: torch.Tensor, cfg: ModelConfig):
    """One decode step for all requests over paged KV.

    tokens: (B,) current token per request; k_pools/v_pools: plain pools,
    or the merged QuantKV pools with v_pools=None; tables: (B, MB) int32;
    lengths: (B,) tokens already in cache (the new token lands at position
    `lengths`). Returns (logits (B, V) f32, k_pools, v_pools)."""
    _check_supported(cfg)
    b = tokens.shape[0]
    quantized = isinstance(k_pools, QuantKV)
    bs = k_pools.q.shape[3] if quantized else k_pools.shape[2]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cos, sin = _rope_tables(cfg, tokens.device)
    lengths = lengths.reshape(b).long()
    rope_pos = _rope_positions(lengths, cfg)

    if _paged_fused_ok(params, cfg, b, k_pools, tables):
        x0 = embed_lookup(params, tokens, cfg)
        x_out, *_ = fused_paged_decode_step(
            params["blocks"], x0, k_pools.q, k_pools.s, tables, lengths,
            cos[rope_pos], sin[rope_pos], cfg=cfg, inplace=True)
        logits = lm_logits(x_out[:, None, :], params, cfg)
        return logits[:, 0], k_pools, v_pools

    x = embed_lookup(params, tokens, cfg)[:, None, :]
    positions = rope_pos[:, None]
    block_ids, offsets = write_position(tables, lengths, bs)
    ctx = lengths + 1
    for l in range(cfg.num_layers):
        bp = layer_view(params["blocks"], l)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        q, k, v = _linear(h, bp["wqkv"]).split([hq * hd, hkv * hd, hkv * hd],
                                               dim=-1)
        q = q.reshape(b, 1, hq, hd)
        k = k.reshape(b, 1, hkv, hd)
        v = v.reshape(b, 1, hkv, hd)
        if cos is not None:
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
        if quantized:
            kq8, ksc = quantize_int8(k[:, 0], axis=-1)
            vq8, vsc = quantize_int8(v[:, 0], axis=-1)
            k_pools.q[l, block_ids, 0, offsets] = kq8.reshape(b, hkv * hd)
            k_pools.q[l, block_ids, 1, offsets] = vq8.reshape(b, hkv * hd)
            # advanced indices around a slice put their axis first: (B, Hkv)
            k_pools.s[l, block_ids, 0, :, offsets] = ksc[..., 0]
            k_pools.s[l, block_ids, 1, :, offsets] = vsc[..., 0]
            attn = int8_paged_decode_attention(q[:, 0], k_pools.q, k_pools.s,
                                               tables, ctx, layer=l)
        else:
            k_pools[l, block_ids, offsets] = k[:, 0].to(k_pools.dtype)
            v_pools[l, block_ids, offsets] = v[:, 0].to(v_pools.dtype)
            attn = paged_decode_attention(q[:, 0], k_pools, v_pools, tables,
                                          ctx, layer=l)
        x = x + _linear(attn.reshape(b, 1, hq * hd), bp["wo"])
        x = x + _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps), cfg)
    logits = lm_logits(x, params, cfg)
    return logits[:, 0], k_pools, v_pools


# the JAX package jits this step; here it runs as it is
paged_decode_step = _paged_decode_step_impl


def paged_decode_scan_impl(params: dict, tokens: torch.Tensor, k_pools,
                           v_pools, tables: torch.Tensor,
                           lengths: torch.Tensor,
                           generator: torch.Generator | None,
                           temps: torch.Tensor, top_ps: torch.Tensor,
                           cfg: ModelConfig, horizon: int = 1, top_ks=None,
                           filtered: bool = True):
    """`horizon` decode steps, sampling included, with no host sync (the
    JAX package's in-device scan). Block tables must already cover
    lengths + horizon (the engine pre-extends). `filtered=False` drops
    top-k/top-p; `top_ks` (B,) gives per-request top-k when filtered.
    Returns (tokens (B, horizon) int32, k_pools, v_pools)."""
    tok, lens, out = tokens, lengths, []
    for _ in range(horizon):
        logits, k_pools, v_pools = _paged_decode_step_impl(
            params, tok, k_pools, v_pools, tables, lens, cfg)
        tok = sample_token(
            logits, generator, temperature=temps,
            top_k=(top_ks if (filtered and top_ks is not None) else 0),
            top_p=top_ps if filtered else None).to(torch.int32)
        out.append(tok)
        lens = lens + 1
    return torch.stack(out, dim=1), k_pools, v_pools


def _gather_prefix(k_pools, v_pools, l: int, table: torch.Tensor,
                   dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Each request's whole (padded) KV range of layer l through its table:
    (R, MB·BS, Hkv, hd) K and V in `dtype`, dequantized from INT8 pools."""
    r, mb = table.shape
    t = table.long()
    if isinstance(k_pools, QuantKV):
        _, _, _, bs, flat = k_pools.q.shape
        hkv = k_pools.s.shape[3]

        def gather_dq(which):
            seq = k_pools.q[l].select(1, which)[t].reshape(r, mb, bs, hkv, -1)
            sc = k_pools.s[l].select(1, which)[t].transpose(2, 3)[..., None]
            return (seq.float() * sc).reshape(r, mb * bs, hkv, -1).to(dtype)

        return gather_dq(0), gather_dq(1)
    _, _, bs, hkv, hd = k_pools.shape
    k_seq = k_pools[l][t].reshape(r, mb * bs, hkv, hd).to(dtype)
    v_seq = v_pools[l][t].reshape(r, mb * bs, hkv, hd).to(dtype)
    return k_seq, v_seq


def paged_prefill_chunk_impl(params: dict, ids: torch.Tensor, k_pools,
                             v_pools, table: torch.Tensor,
                             start: torch.Tensor, nvalid: torch.Tensor,
                             cfg: ModelConfig):
    """Prefill one chunk of R requests into their paged blocks, batched.

    ids: (R, C) chunk tokens right-padded; table: (R, MB) block tables;
    start: (R,) each chunk's first position; nvalid: (R,) real tokens per
    chunk (0 = padding row: logits the caller ignores). The K/V of padding
    tokens are written to the trash block, the pools' last block (index
    NB - 1), and nowhere else. Attends each request's whole MB·BS prefix
    gathered from the pools, the chunk just written included, with flash
    attention at per-request q_offset.
    A 1-D table with scalar start/nvalid is one request. Returns
    (last-valid-position logits (R, V) f32, k_pools, v_pools)."""
    _check_supported(cfg)
    dev = ids.device
    if table.dim() == 1:
        table = table[None]
        start = torch.as_tensor(start, device=dev).reshape(1)
        nvalid = torch.as_tensor(nvalid, device=dev).reshape(1)
    r, c = ids.shape
    quantized = isinstance(k_pools, QuantKV)
    bs = k_pools.q.shape[3] if quantized else k_pools.shape[2]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    start, nvalid = start.long(), nvalid.long()

    x = embed_lookup(params, ids, cfg)
    cos, sin = _rope_tables(cfg, dev)
    positions = start[:, None] + torch.arange(c, device=dev)[None, :]  # (R, C)
    rope_pos = _rope_positions(positions, cfg)
    # scatter targets: the real tokens' blocks, the trash block for the
    # padding (JAX routes the padding past the pool and drops it)
    trash = (k_pools.q if quantized else k_pools).shape[1] - 1
    real = torch.arange(c, device=dev)[None, :] < nvalid[:, None]
    col = (positions // bs).clamp(max=table.shape[1] - 1)
    blk = torch.where(real, table.long().gather(1, col),
                      trash).reshape(r * c)
    off = (positions % bs).reshape(r * c)

    for l in range(cfg.num_layers):
        bp = layer_view(params["blocks"], l)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        q, k, v = _linear(h, bp["wqkv"]).split([hq * hd, hkv * hd, hkv * hd],
                                               dim=-1)
        q = q.reshape(r, c, hq, hd)
        k = k.reshape(r, c, hkv, hd)
        v = v.reshape(r, c, hkv, hd)
        if cos is not None:
            q = apply_rope(q, cos, sin, rope_pos)
            k = apply_rope(k, cos, sin, rope_pos)
        kf = k.reshape(r * c, hkv, hd)
        vf = v.reshape(r * c, hkv, hd)
        if quantized:
            kq8, ksc = quantize_int8(kf, axis=-1)
            vq8, vsc = quantize_int8(vf, axis=-1)
            k_pools.q[l, blk, 0, off] = kq8.reshape(-1, hkv * hd)
            k_pools.q[l, blk, 1, off] = vq8.reshape(-1, hkv * hd)
            k_pools.s[l, blk, 0, :, off] = ksc[..., 0]
            k_pools.s[l, blk, 1, :, off] = vsc[..., 0]
        else:
            k_pools[l, blk, off] = kf.to(k_pools.dtype)
            v_pools[l, blk, off] = vf.to(v_pools.dtype)
        k_seq, v_seq = _gather_prefix(k_pools, v_pools, l, table, q.dtype)
        attn = flash_attention(q.transpose(1, 2), k_seq.transpose(1, 2),
                               v_seq.transpose(1, 2), q_offset=start,
                               causal=True)
        attn = attn.transpose(1, 2).reshape(r, c, hq * hd)
        x = x + _linear(attn, bp["wo"])
        x = x + _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps), cfg)
    last = x[torch.arange(r, device=dev), (nvalid - 1).clamp_min(0)]
    return lm_logits(last, params, cfg), k_pools, v_pools
