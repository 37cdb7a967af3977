"""Dense GQA transformer as plain functions over a parameter dict
(counterpart: physics_llm_inference_tpu/models/transformer.py).

The parameter dict has the JAX pytree's keys and stacked layouts: `embed`
(V, D); `blocks` with leading layer axis L (`ln1`, `wqkv`, `wo`, `ln2`,
`w_gate_up`, `w_down`); `norm` (D,); `lm_head` (D, V). INT8 weights are
`QuantizedTensor`s, INT4 block weights `QuantizedTensor4`s (models/quant.py).

What differs from the JAX package, on purpose:
- The layer loop is a Python loop over zero-copy layer views
  (`w.q[layer]`), where JAX scans with in-kernel layer indexing.
- KV caches are written IN PLACE (`_cache_write` mutates the cache tensors);
  JAX rebuilds its arrays functionally and aliases them under jit.
- The fresh-KV prefill branch is the explicit `fresh_kv` argument, not a
  test of `k_limit == s`.
- "On the accelerator" means a CUDA tensor. There a decode step that
  passes the JAX package's fused gate runs the whole-model decode kernel
  (fused_decode_step: W8A16, W4A16 with INT4 stacks, W8A8 with
  `act_quant="int8"`), and the others the per-op kernels (int8_matmul,
  int8_kv_decode_attention); prefill from 512 slots of context runs
  flash_attention; the greedy head runs lmhead_greedy. INT4 linears outside
  the fused kernel are a dequantize-then-GEMM, as the JAX package leaves
  them to XLA. On a CPU tensor
  the JAX gates are false, as on the JAX CPU backend, and both packages take
  the same per-op/dense path; `_fused_decode_forward` is the fused branch
  itself, callable on the CPU, where the kernels take their plain versions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from ..kernels.fused_decode import fused_decode_step, write_slots
from ..kernels.int8_kv_attention import int8_kv_decode_attention
from ..kernels.int8_matmul import int8_matmul, int8_matmul_plain
from ..kernels.lmhead import lmhead_greedy, lmhead_greedy_ok
from ..kernels.quant import quantize_int8
from ..ops.gqa import grouped_sdpa
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_frequencies
from .config import ModelConfig, torch_dtype
from .quant import QuantizedTensor, QuantizedTensor4

# m at and above which a CUDA linear leaves the int8 kernel for torch.matmul,
# as the JAX package leaves prefill-sized matmuls to XLA
_PREFILL_M = 2048


class QuantKV(NamedTuple):
    """INT8 KV storage: values FLAT (…, S, Hkv·hd) int8, per-(token, head)
    scales TRANSPOSED (…, Hkv, S) f32 — the layouts the decode kernel reads."""

    q: torch.Tensor
    s: torch.Tensor


class KVSlice(NamedTuple):
    """Stacked caches + the first slot of this call's tokens (int, or a (B,)
    tensor of per-request slots)."""

    k: torch.Tensor | QuantKV
    v: torch.Tensor | QuantKV
    start: int | torch.Tensor


def _linear_f32(x2: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """(M, K) @ w (K, N) -> f32 (M, N): the product of x2 and w.q cast to
    x2's dtype (exact for int8), accumulated in f32, then the per-channel
    scale — the XLA branch of the JAX package's `_linear`
    (transformer.py:138-143) before its cast. On the card a library GEMM
    with f32 output (the JAX package leaves this product to XLA, outside
    any Pallas kernel); on the CPU int8_matmul_plain's math."""
    if not x2.is_cuda:
        return int8_matmul_plain(x2, w.q, w.s, out_dtype=torch.float32)
    wq = w.q.to(x2.dtype)
    acc = (torch.mm(x2, wq) if x2.dtype == torch.float32
           else torch.mm(x2, wq, out_dtype=torch.float32))
    return acc.mul_(w.s.reshape(1, -1))


def _linear_int4(x: torch.Tensor, w: QuantizedTensor4) -> torch.Tensor:
    """x (..., K) @ one layer's INT4 weights (K, N), the JAX package's INT4
    branch of `_linear` (transformer.py:87-96): the weights dequantized to
    x's dtype (q·s in f32, then the cast), a product with f32 output (on the
    card a library GEMM; the JAX package computes it in XLA outside any
    Pallas kernel), then the cast."""
    wd = w.dequantize(x.dtype)
    k, n = wd.shape
    x2 = x.reshape(-1, k)
    if x2.is_cuda and x2.dtype != torch.float32:
        acc = torch.mm(x2, wd, out_dtype=torch.float32)
    else:
        acc = x2.float() @ wd.float()
    return acc.to(x.dtype).reshape(*x.shape[:-1], n)


def _linear(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., K) @ w -> (..., N). A plain tensor is a plain matmul. A
    QuantizedTensor (K, N) goes to int8_matmul (the CUDA kernel on the card,
    its plain version on the CPU), except for prefill-sized m >= 2048 on the
    card, which takes `_linear_f32`, as the JAX package leaves that case to
    XLA. A QuantizedTensor4 takes `_linear_int4`."""
    if isinstance(w, QuantizedTensor4):
        return _linear_int4(x, w)
    if not isinstance(w, QuantizedTensor):
        return x @ w
    k, n = w.q.shape
    x2 = x.reshape(-1, k)
    if x.is_cuda and x2.shape[0] >= _PREFILL_M:
        out = _linear_f32(x2, w).to(x.dtype)
    else:
        out = int8_matmul(x2.contiguous(), w.q, w.s, out_dtype=x.dtype)
    return out.reshape(*x.shape[:-1], n)


def _write_seq(buf: torch.Tensor, val: torch.Tensor, start, axis: int):
    """In place: buf[b, ..., start_b + i (on `axis`), ...] = val[b, ..., i].
    buf/val have the batch on axis 0 and the sequence on `axis` (1 or 2).

    With a tensor `start`, a write of several positions that runs past the
    cache (a prefill chunk's padding) lands its excess on the last slot,
    which no query attends; the tokens before it stay in place, where JAX's
    dynamic_update_slice would shift the whole write back. A one-position
    write arrives with its start clamped already (`forward`)."""
    s = val.shape[axis]
    if isinstance(start, int):
        buf.narrow(axis, start, s).copy_(val)
        return
    b = buf.shape[0]
    start = torch.as_tensor(start, device=buf.device).reshape(-1).expand(b)
    idx = start.long()[:, None] + torch.arange(s, device=buf.device)
    if s > 1:
        idx = idx.clamp(max=buf.shape[axis] - 1)
    bidx = torch.arange(b, device=buf.device)[:, None]
    if axis == 1:
        buf[bidx, idx] = val
    else:  # advanced indices first, then the sliced axis: (B, s, H)
        buf[bidx, :, idx] = val.transpose(1, 2)


def _cache_write(cache, new: torch.Tensor, start, layer: int | None = None):
    """Write new K or V (B, s, Hkv, hd) into the cache IN PLACE at slot
    offset `start`, at `layer` of a stacked cache. A QuantKV cache gets the
    int8 values (flat) and per-(token, head) scales (transposed). Returns the
    same cache object."""
    if isinstance(cache, QuantKV):
        qv, sv = quantize_int8(new, axis=-1)
        b, s = new.shape[:2]
        vals = cache.q if layer is None else cache.q[layer]
        scales = cache.s if layer is None else cache.s[layer]
        _write_seq(vals, qv.reshape(b, s, -1), start, axis=1)
        _write_seq(scales, sv[..., 0].transpose(1, 2), start, axis=2)
        return cache
    buf = cache if layer is None else cache[layer]
    _write_seq(buf, new.to(cache.dtype), start, axis=1)
    return cache


def _dequant_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """Flat int8 (..., S, Hkv·hd) + transposed scales (..., Hkv, S) ->
    (..., S, Hkv, hd) in `dtype`."""
    scale = s.transpose(-1, -2)[..., None]
    vals = q.reshape(*q.shape[:-1], s.shape[-2], -1)
    return (vals.float() * scale).to(dtype)


def _cache_read(cache, dtype) -> torch.Tensor:
    """The whole cache, dequantized to `dtype`: (..., S, Hkv, hd)."""
    if isinstance(cache, QuantKV):
        return _dequant_kv(cache.q, cache.s, dtype)
    return cache.to(dtype)


def _cache_read_layer(cache, layer: int, dtype) -> torch.Tensor:
    """One layer of the stacked cache, dequantized: (B, S, Hkv, hd)."""
    if isinstance(cache, QuantKV):
        return _dequant_kv(cache.q[layer], cache.s[layer], dtype)
    return cache[layer].to(dtype)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> dict:
    """Random dense parameters in the JAX layout (weights ~ N(0, 1/fan_in))."""
    device = torch.device(device) if device is not None else generator.device
    dtype = torch_dtype(cfg)
    d, f, v, L = cfg.hidden_dim, cfg.intermediate_dim, cfg.vocab_size, \
        cfg.num_layers
    hd = cfg.head_dim

    def w(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device)
                * fan_in ** -0.5).to(dtype)

    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    blocks = {
        "ln1": torch.ones((L, d), dtype=dtype, device=device),
        "wqkv": w((L, d, qkv_out), d),
        "wo": w((L, cfg.num_heads * hd, d), d),
        "ln2": torch.ones((L, d), dtype=dtype, device=device),
        "w_gate_up": w((L, d, 2 * f), d),
        "w_down": w((L, f, d), f),
    }
    return {"embed": w((v, d), d), "blocks": blocks,
            "norm": torch.ones((d,), dtype=dtype, device=device),
            "lm_head": w((d, v), d)}


def layer_view(blocks: dict, layer: int) -> dict:
    """One layer's parameters as zero-copy views of the stacks."""
    out = {}
    for name, w in blocks.items():
        if isinstance(w, (QuantizedTensor, QuantizedTensor4)):
            out[name] = type(w)(w.q[layer], w.s[layer])
        else:
            out[name] = w[layer]
    return out


def embed_lookup(params: dict, input_ids: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][input_ids].to(torch_dtype(cfg))


def lm_logits(x: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    """Final norm + lm_head, f32 logits."""
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    return _linear(x, params["lm_head"]).float()


def _ffn(bp: dict, h: torch.Tensor) -> torch.Tensor:
    """Dense fused SwiGLU (MoE is not ported)."""
    gate, up = _linear(h, bp["w_gate_up"]).chunk(2, dim=-1)
    return _linear(F.silu(gate) * up, bp["w_down"])


def _attend(q, k, v, q_slots, k_slots, valid_from=None):
    """Grouped attention with the unified mask k_slot <= q_slot (and
    k_slot >= valid_from[b]). q: (B, Hq, Sq, hd); k, v: (B, Hkv, Sk, hd)."""
    mask = k_slots[None, None, :] <= q_slots[:, :, None]
    if valid_from is not None:
        mask = mask & (k_slots[None, None, :] >= valid_from[:, None, None])
    return grouped_sdpa(q, k, v, mask=mask[:, None, None, :, :])


def _cache_capacity(kv) -> int:
    arr = kv[0].q if isinstance(kv[0], QuantKV) else kv[0]
    stacked = arr.dim() == (4 if isinstance(kv[0], QuantKV) else 5)
    return arr.shape[2] if stacked else arr.shape[1]


def _resolve_attention(cfg: ModelConfig, b: int, s: int, kv,
                       on_cuda: bool) -> str:
    """`auto` -> flash exactly where the JAX package picks flash on its
    accelerator (transformer.py:461-482), else dense."""
    impl = cfg.attention_impl
    if impl != "auto":
        return impl
    sk = _cache_capacity(kv) if kv is not None else s
    score_mb = b * cfg.num_heads * s * sk * 2 / (1 << 20)
    if on_cuda and s >= 128 and (max(s, sk) >= 512 or score_mb > 512):
        return "flash"
    return "dense"


def block_forward(bp: dict, x: torch.Tensor, cfg: ModelConfig,
                  rope_cos, rope_sin, positions: torch.Tensor,
                  kv=None, start=None, slots=None, valid_from=None,
                  layer: int | None = None, k_limit: int | None = None,
                  fresh_kv: bool = False):
    """One pre-norm block: GQA attention + residual, SwiGLU + residual.

    With kv=(k_cache, v_cache) the new K/V are written in place at `layer`
    and slot offset `start`, and attention reads that layer's cache.
    `fresh_kv=True` (one-shot prefill at start 0) attends the freshly
    computed post-RoPE K/V directly instead of reading them back from the
    cache. Returns (x, kv)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    on_cuda = x.is_cuda

    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = _linear(h, bp["wqkv"]).split([hq * hd, hkv * hd, hkv * hd],
                                           dim=-1)
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if rope_cos is not None:
        q = apply_rope(q, rope_cos, rope_sin, positions)
        k = apply_rope(k, rope_cos, rope_sin, positions)
    if slots is None:
        slots = positions
    impl = _resolve_attention(cfg, b, s, kv, on_cuda)

    if kv is None:
        if fresh_kv:
            raise ValueError("fresh_kv needs a KV cache to write")
        kq, vq = k.transpose(1, 2), v.transpose(1, 2)
        k_slots = torch.arange(s, device=x.device)
    else:
        k_cache, v_cache = kv
        _cache_write(k_cache, k, start, layer=layer)
        _cache_write(v_cache, v, start, layer=layer)

        if (s == 1 and isinstance(k_cache, QuantKV) and on_cuda
                and cfg.attention_impl != "dense"):
            # INT8-KV decode: the kernel reads the int8 cache directly
            attn = int8_kv_decode_attention(
                q[:, 0].contiguous(), k_cache.q, k_cache.s, v_cache.q,
                v_cache.s, q_slot=slots[:, 0], valid_from=valid_from,
                layer=layer)
            x = x + _linear(attn.reshape(b, 1, hq * hd), bp["wo"])
            x = x + _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps))
            return x, kv

        if fresh_kv:
            if not (isinstance(start, int) and start == 0) or \
                    (k_limit is not None and k_limit != s):
                raise ValueError("fresh_kv is one-shot prefill: start 0, "
                                 "k_limit == s")
            kq, vq = k.transpose(1, 2), v.transpose(1, 2)
            k_slots = torch.arange(s, device=x.device)
        else:
            if layer is None:
                kd, vd = _cache_read(k_cache, q.dtype), _cache_read(v_cache,
                                                                    q.dtype)
            else:
                kd = _cache_read_layer(k_cache, layer, q.dtype)
                vd = _cache_read_layer(v_cache, layer, q.dtype)
            kq, vq = kd.transpose(1, 2), vd.transpose(1, 2)
            if k_limit is not None and k_limit < kq.shape[2]:
                kq, vq = kq[:, :, :k_limit], vq[:, :, :k_limit]
            k_slots = torch.arange(kq.shape[2], device=x.device)

    if impl == "flash":
        # every runtime path uses affine slots (slots = start + arange),
        # which is the kernel's rectangular-causal mask; valid_from masks
        # left padding
        attn = flash_attention(q.transpose(1, 2), kq, vq,
                               q_offset=0 if kv is None else start,
                               causal=True, valid_from=valid_from)
    else:
        attn = _attend(q.transpose(1, 2), kq, vq, slots, k_slots, valid_from)
    attn = attn.transpose(1, 2).reshape(b, s, hq * hd)
    x = x + _linear(attn, bp["wo"])
    x = x + _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps))
    return x, kv


def _fused_decode_ok(params: dict, cfg: ModelConfig, b: int,
                     kv: KVSlice) -> bool:
    """The JAX package's gate for its fused whole-model decode kernel
    (transformer.py:570-613), without the backend test: all four block
    stacks int8 (W8A16, or W8A8 with `act_quant="int8"`) or all int4 with
    no activation quantization (W4A8 takes the per-op path)."""
    if not (cfg.fused_decode and cfg.num_experts == 0 and cfg.use_rope
            and cfg.attention_impl != "dense" and cfg.tp_axis is None):
        return False
    if not isinstance(kv.k, QuantKV):
        return False
    blocks = params["blocks"]
    mats = [blocks.get(n) for n in ("wqkv", "wo", "w_gate_up", "w_down")]
    kinds = {type(w) for w in mats}
    if kinds == {QuantizedTensor4}:
        if cfg.act_quant != "none":
            return False
    elif kinds != {QuantizedTensor}:
        return False
    if any(w.q.dim() != 3 for w in mats):
        return False
    d, f, hd = cfg.hidden_dim, cfg.intermediate_dim, cfg.head_dim
    qo = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    s_max = kv.k.q.shape[2]
    return (hd % 128 == 0 and b % 8 == 0 and qo % 128 == 0
            and d % 128 == 0 and f % 128 == 0 and s_max % 8 == 0
            and 8 * s_max * cfg.num_kv_heads * hd <= (8 << 20))


def _fused_decode_forward(params: dict, x: torch.Tensor, cfg: ModelConfig,
                          kv: KVSlice, positions, slots, valid_from,
                          rope_cos, rope_sin):
    """The fused branch of the JAX package's forward (transformer.py:
    688-717): one fused_decode_step runs every layer. x: (B, 1, D) embedded
    tokens. The kernel writes the new K/V in place at each request's start
    slot, which it reads from the device (an int start, or a 0-d or (B,)
    tensor), where the JAX package scatters per-request starts after the
    call: nothing of the step is a host value that changes between steps.
    Returns (x (B, 1, D), kv)."""
    b = x.shape[0]
    start = kv.start
    wslot = write_slots(start, b, x.device)
    q_slot = slots[:, 0] if slots is not None else wslot
    pos = positions[:, 0].clamp(0, rope_cos.shape[0] - 1)  # as JAX clamps
    x_out, *_ = fused_decode_step(
        params["blocks"], x[:, 0], kv.k.q, kv.k.s, kv.v.q, kv.v.s, q_slot,
        valid_from, rope_cos[pos], rope_sin[pos], cfg, slot=wslot,
        write_cache=True)
    return x_out[:, None, :], KVSlice(kv.k, kv.v, kv.start + 1)


def forward(params: dict, input_ids: torch.Tensor, cfg: ModelConfig,
            kv: KVSlice | None = None, positions=None, slots=None,
            valid_from=None, last_only: bool = False,
            greedy_head: bool = False, k_limit: int | None = None,
            fresh_kv: bool = False):
    """embed -> blocks -> norm -> lm_head. input_ids: (B, S).

    With `kv`, the tokens occupy cache slots [kv.start, kv.start + S) (caches
    updated in place) and the returned KVSlice has start advanced by S.
    `positions` (B, S) are RoPE positions, `slots` (B, S) cache slots for the
    mask, `valid_from` (B,) masks left padding. `last_only` keeps the last
    position. `greedy_head` returns greedy ids (B,) int32 through the fused
    head kernel where the JAX gate takes it. `k_limit` statically bounds the
    attended cache slots; `fresh_kv` selects the one-shot prefill branch.
    Returns (logits or ids, kv)."""
    if cfg.num_experts > 0 or cfg.tp_axis is not None:
        raise NotImplementedError("MoE and tensor parallelism are not ported "
                                  "yet (ROADMAP Queue A)")
    b, s = input_ids.shape
    x = embed_lookup(params, input_ids, cfg)
    dev = x.device

    if positions is None:
        base = kv.start if kv is not None else 0
        if isinstance(base, torch.Tensor) and base.dim() == 1:
            base = base[:, None]
        positions = (torch.arange(s, device=dev)[None, :] + base).expand(b, s)

    rope_cos = rope_sin = None
    if cfg.use_rope:
        rope_cos, rope_sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                              cfg.rope_theta, device=dev)

    blocks = params["blocks"]
    if kv is None:
        for layer in range(cfg.num_layers):
            x, _ = block_forward(layer_view(blocks, layer), x, cfg, rope_cos,
                                 rope_sin, positions, slots=slots,
                                 valid_from=valid_from)
        new_kv = None
    else:
        if s == 1 and x.is_cuda and _fused_decode_ok(params, cfg, b, kv):
            x, new_kv = _fused_decode_forward(params, x, cfg, kv, positions,
                                              slots, valid_from, rope_cos,
                                              rope_sin)
        else:
            start = kv.start
            if s == 1 and isinstance(start, torch.Tensor):
                # a parked row's decode steps walk past the cache: its
                # write lands on the last slot, as JAX clamps the start;
                # no active row attends that slot
                start = start.clamp(max=_cache_capacity((kv.k, kv.v)) - 1)
            for layer in range(cfg.num_layers):
                x, _ = block_forward(layer_view(blocks, layer), x, cfg,
                                     rope_cos, rope_sin, positions,
                                     kv=(kv.k, kv.v), start=start,
                                     slots=slots, valid_from=valid_from,
                                     layer=layer, k_limit=k_limit,
                                     fresh_kv=fresh_kv)
            new_kv = KVSlice(kv.k, kv.v, kv.start + s)

    if last_only:
        x = x[:, -1:, :]
    if greedy_head:
        lm = params["lm_head"]
        if (isinstance(lm, QuantizedTensor) and lm.q.dim() == 2
                and lmhead_greedy_ok(x.shape[0], lm.q.shape[0],
                                     lm.q.shape[1], x.element_size())):
            tok = lmhead_greedy(x[:, -1, :].contiguous(), params["norm"],
                                lm.q, lm.s, eps=cfg.norm_eps)
            return tok, new_kv
        logits = lm_logits(x, params, cfg)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), new_kv
    return lm_logits(x, params, cfg), new_kv
