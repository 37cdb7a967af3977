"""Multi-head latent attention (MLA), DeepSeek-V2's attention (arXiv:
2405.04434; `DeepseekV2Attention` of the model's modeling_deepseek.py),
without q-LoRA, over a cache of the compressed latent.

A layer's parameters (one layer's views, `transformer.layer_view`): `wq`
(D, H·(dn + dr)), `wkv_a` (D, R + dr) (`kv_a_proj_with_mqa`), `kv_ln` (R,)
(`kv_a_layernorm`), `wkv_b` (R, H·(dn + dv)) (`kv_b_proj`: per head dn
columns of k_nope, then dv of v) and `wo` (H·dv, D), with R =
kv_lora_rank, dn / dr the query's nope and rope widths, dv the value's.

    q = h wq -> (q_nope, q_pe);  (c, k_pe) = h wkv_a;  c = rmsnorm(c)
    q_pe, k_pe: de-interleaved, then rotated (YaRN; ops/rope.py)
    k_nope, v = c wkv_b;  k = (k_nope, k_pe shared by every head)
    softmax(q k^T * scale) v -> wo, scale = (dn + dr)^-0.5 * mscale^2

The cache (`LatentKV`) holds, a token and layer, int8 codes of the R-wide
latent and of the dr-wide rotated rope key, each with its own f32 scale
(per token, absmax / 127, as the INT8 K/V cache quantizes a head): R + dr
+ 8 bytes (584 at DeepSeek-V2's widths, against 2·H·(dn + dr + 4) = 6,272
for a decompressed INT8 K/V of the same heads).

- Prefill (a call of several tokens) decompresses: k_nope and v from the
  latent through wkv_b, attention per head over q/k of dn + dr and v of dv
  (K5, `kernels/flash_attention`, on the card).
- Decode (one token a row) absorbs: q_nope goes through each head's
  k_nope block of wkv_b into the latent space, attention runs over one
  (R + dr)-wide head of cached latent and rope key shared by all H query
  heads (`kernels/mla_decode`), the value is the latent itself, and each
  head's R-wide output goes through its v block of wkv_b, then wo.

Departures from the published forward, on purpose:
- The latent and the rope key go through the int8 cache format before any
  attention reads them, in prefill as in decode, so both read the same
  keys and values (the published model caches bf16 keys and values).
- The absorbed decode computes the same scores and values as the
  decompressed form in another order: q_nope · (W_UK c) as (q_nope W_UK) · c.
  Its products run in the activation dtype: q_nope times the k_nope
  columns' scales, rounded once, against the int8 codes (exact in bf16);
  the value products against the codes, then the v columns' scales in f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.mla_decode import mla_decode_attention
from ..kernels.quant import quantize_int8
from ..ops.norms import rms_norm
from ..ops.rope import (apply_rope_deinterleaved, yarn_attention_scale,
                        yarn_cos_sin, yarn_inv_freq)
from .quant import QuantizedTensor, QuantizedTensor4


class LatentKV(NamedTuple):
    """The MLA cache: codes (L, B, S, R + dr) int8 (the latent's R, then the
    rope key's dr) and scales TRANSPOSED (L, B, 2, S) f32 (the latent's,
    then the rope key's), the layouts the decode kernel reads."""

    q: torch.Tensor
    s: torch.Tensor


def latent_bytes_per_token(cfg) -> int:
    """Cache bytes a token and layer: the codes and two f32 scales."""
    return cfg.kv_lora_rank + cfg.qk_rope_head_dim + 8


def attention_scale(cfg) -> float:
    return yarn_attention_scale(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                                cfg.rope_yarn)


def rope_cos_sin(cfg, positions: torch.Tensor):
    """(cos, sin) (B, S, dr // 2) f32 of YaRN's frequencies for the rope
    key's width at `positions` (B, S), computed from the positions, so no
    table bounds them."""
    inv = yarn_inv_freq(cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_yarn,
                        device=positions.device)
    return yarn_cos_sin(positions, inv, cfg.rope_yarn)


def _quantized(t: torch.Tensor):
    """(codes int8, scale f32 (..., 1), the dequantized values in t's
    dtype) of the int8 cache format over the last axis."""
    q, s = quantize_int8(t, axis=-1)
    return q, s, (q.float() * s).to(t.dtype)


def _kv_b(w, cfg):
    """wkv_b as (codes or weights (R, H, dn + dv), scales (H, dn + dv) or
    None)."""
    h = cfg.num_heads
    width = cfg.qk_nope_head_dim + cfg.v_head_dim
    if isinstance(w, QuantizedTensor4):
        w = w.dequantize(torch.float32)
    if isinstance(w, QuantizedTensor):
        return (w.q.view(-1, h, width),
                w.s.reshape(h, width))
    return w.view(-1, h, width), None


def mla_attention(bp: dict, h: torch.Tensor, cfg, cos, sin, kv=None,
                  start=None, slots=None, valid_from=None,
                  layer: int | None = None,
                  fresh_kv: bool = False) -> torch.Tensor:
    """One layer's attention on the normed input h (B, s, D), with its
    output projection: (B, s, D). With kv (a LatentKV), the tokens' latent
    and rope key are written at `layer`, slot offset `start`, and decode
    (s == 1) reads the cache through the absorbed form; a prefill (with a
    cache: `fresh_kv`, at start 0) attends its own tokens, decompressed."""
    from .transformer import _linear, _write_seq

    b, s, _ = h.shape
    H, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, R = cfg.v_head_dim, cfg.kv_lora_rank
    q = _linear(h, bp["wq"]).view(b, s, H, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c, k_pe = _linear(h, bp["wkv_a"]).split([R, dr], dim=-1)
    c = rms_norm(c, bp["kv_ln"], cfg.norm_eps)
    q_pe = apply_rope_deinterleaved(q_pe, cos, sin)
    k_pe = apply_rope_deinterleaved(k_pe[:, :, None, :], cos, sin)[:, :, 0]
    cq, cs, c = _quantized(c)
    pq, ps, k_pe = _quantized(k_pe)
    scale = attention_scale(cfg)
    if kv is not None:
        _write_seq(kv.q[layer], torch.cat([cq, pq], dim=-1), start, axis=1)
        _write_seq(kv.s[layer], torch.cat([cs, ps], dim=-1).transpose(1, 2),
                   start, axis=2)
        if s == 1:
            q_slot = (slots[:, 0] if slots is not None
                      else torch.as_tensor(start, device=h.device)
                      .reshape(-1).expand(b))
            o = _absorbed_decode(bp, q_nope[:, 0], q_pe[:, 0], kv, layer,
                                 q_slot, valid_from, cfg, scale)
            return _linear(o.reshape(b, 1, H * dv), bp["wo"])
        if not fresh_kv:
            raise NotImplementedError(
                "MLA prefill is one-shot (fresh_kv): chunks against a "
                "latent cache are not taken yet")
    k_nope, v = _linear(c, bp["wkv_b"]).view(b, s, H, dn + dv).split(
        [dn, dv], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, H, dr)], dim=-1)
    qf = torch.cat([q_nope, q_pe], dim=-1)
    attn = flash_attention(qf.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), q_offset=0, causal=True,
                           valid_from=valid_from, scale=scale)
    return _linear(attn.transpose(1, 2).reshape(b, s, H * dv), bp["wo"])


def _absorbed_decode(bp, q_nope, q_pe, kv, layer, q_slot, valid_from, cfg,
                     scale):
    """q_nope (B, H, dn), q_pe (B, H, dr) -> each head's value output
    (B, H, dv): the queries absorbed into the latent space, one shared
    latent head attended, the output through the v blocks of wkv_b."""
    dn = cfg.qk_nope_head_dim
    dt = q_nope.dtype
    codes, sc = _kv_b(bp["wkv_b"], cfg)
    if sc is not None:
        q_nope = (q_nope.float() * sc[:, :dn]).to(dt)
    wuk = codes[:, :, :dn].permute(1, 2, 0).to(dt)          # (H, dn, R)
    q_lat = torch.bmm(q_nope.transpose(0, 1), wuk).transpose(0, 1)
    qf = torch.cat([q_lat, q_pe], dim=-1).contiguous()       # (B, H, R + dr)
    o_lat = mla_decode_attention(qf, kv.q[layer], kv.s[layer], q_slot,
                                 valid_from, scale,
                                 rank=cfg.kv_lora_rank)      # (B, H, R)
    wuv = codes[:, :, dn:].permute(1, 0, 2).to(dt)           # (H, R, dv)
    o = torch.bmm(o_lat.transpose(0, 1), wuv).transpose(0, 1)
    if sc is not None:
        o = (o.float() * sc[:, dn:]).to(dt)
    return o
