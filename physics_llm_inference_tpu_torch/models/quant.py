"""INT8 and INT4 weight-only model quantization (counterpart:
physics_llm_inference_tpu/models/quant.py).

INT8: every block matmul weight (and the lm_head) becomes a QuantizedTensor:
int8 values plus per-output-channel f32 scales. Stacked block weights keep
the JAX layout: q (L, K, N) int8, s (L, 1, N) f32 (MoE expert stacks q
(L, E, K, N), s (L, E, 1, N)); the lm_head is q (D, V), s (1, V). INT4
(W4A16): the block weights become QuantizedTensor4s, nibble-packed values
with group-wise scales whose group is the fused decode kernel's K-tile
(`kernels/fused_decode.int4_group_size`), the MoE expert stacks stay INT8;
the lm_head stays int8. Embeddings and norms stay in the model dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

import numpy as np

from ..kernels.quant import quantize_int8
from .config import ModelConfig, torch_dtype


class QuantizedTensor(NamedTuple):
    """int8 values + broadcastable f32 scale (reduction axes have size 1)."""

    q: torch.Tensor
    s: torch.Tensor

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """q·s in f32, then the cast to `dtype`, in one pass: the product
        is computed in f32 and rounded as `(q.float() * s).to(dtype)`
        rounds it, without the f32 copy."""
        return torch.mul(self.q, self.s, out=torch.empty(
            self.q.shape, dtype=dtype, device=self.q.device))


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """Nibble-packed int8 (..., N/2) -> int32 values in [-8, 7] (..., N): the
    low nibbles are channels [0, N/2), the high ones [N/2, N). Two arithmetic
    shifts in int32, as the TPU kernel's `_w` unpacks a tile."""
    t = q.to(torch.int32)
    return torch.cat([(t << 28) >> 28, t >> 4], dim=-1)


class QuantizedTensor4(NamedTuple):
    """INT4 weights: nibble-packed values + group-wise scales.

    q: int8 (L, K, N/2), or one layer's (K, N/2): byte j of a row holds
       output channel j in the low nibble and channel N/2 + j in the high
       nibble, two's complement.
    s: f32 (L, K/G, N), or (K/G, N): one scale per (K-group, channel), with
       G the fused decode kernel's K-tile for this matrix."""

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self) -> tuple:
        return (*self.q.shape[:-1], 2 * self.q.shape[-1])

    @property
    def group(self) -> int:
        return self.q.shape[-2] // self.s.shape[-2]

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """The (…, K, N) weights: q·s in f32, then the cast."""
        s = self.s.repeat_interleave(self.group, dim=-2)
        return (unpack_int4(self.q).float() * s).to(dtype)

    def dequantize_layer(self, layer: int, dtype=torch.bfloat16):
        """One layer's (K, N) weights of a stack (the per-op/prefill path)."""
        return QuantizedTensor4(self.q[layer], self.s[layer]).dequantize(dtype)


_QUANT_LEAVES = ("wqkv", "wo", "w_gate_up", "w_down",
                 "moe_w1", "moe_w2", "moe_w3")


def quantize_params_int8(params: dict) -> dict:
    """Quantize all block matmul weights and the lm_head: a stack (L, K, N)
    gets per-(layer, channel) scales (L, 1, N), an MoE expert stack
    (L, E, K, N) per-(layer, expert, channel) scales (L, E, 1, N). The
    router gate stays in the model dtype, as in the JAX package."""
    blocks = {}
    for name, w in params["blocks"].items():
        if name in _QUANT_LEAVES:
            blocks[name] = QuantizedTensor(*quantize_int8(w, axis=-2))
        else:
            blocks[name] = w
    return {"embed": params["embed"], "norm": params["norm"],
            "blocks": blocks,
            "lm_head": QuantizedTensor(*quantize_int8(params["lm_head"], axis=0))}


def init_params_int8(generator: torch.Generator, cfg: ModelConfig,
                     device=None) -> dict:
    """Initialize a model directly in the INT8 format, on `device` (default:
    the generator's device), so a 7B-class init never passes through the host
    or a bf16 copy. int8 values are uniform in [-127, 127]; scales are set so
    the dequantized std is fan_in**-0.5, as in the JAX package's
    init_params_int8 (the bits differ: torch and jax draw different numbers)."""
    device = torch.device(device) if device is not None else generator.device
    d, f, v = cfg.hidden_dim, cfg.intermediate_dim, cfg.vocab_size
    hd, L = cfg.head_dim, cfg.num_layers
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    dtype = torch_dtype(cfg)

    def qw(shape, fan_in):
        q = torch.randint(-127, 128, shape, dtype=torch.int8,
                          generator=generator, device=device)
        # 73.9 = std of a uniform int8 in [-127, 127]
        s = torch.full(shape[:-2] + (1, shape[-1]), (fan_in ** -0.5) / 73.9,
                       dtype=torch.float32, device=device)
        return QuantizedTensor(q, s)

    blocks = {
        "ln1": torch.ones((L, d), dtype=dtype, device=device),
        "wqkv": qw((L, d, qkv_out), d),
        "wo": qw((L, cfg.num_heads * hd, d), d),
        "ln2": torch.ones((L, d), dtype=dtype, device=device),
        "w_gate_up": qw((L, d, 2 * f), d),
        "w_down": qw((L, f, d), f),
    }
    emb = (torch.randn((v, d), generator=generator, device=device)
           * (d ** -0.5)).to(dtype)
    return {
        "embed": emb,
        "blocks": blocks,
        "norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": qw((d, v), d),
    }


def _quantize_stacked_int4(w: torch.Tensor, group: int,
                           mse: bool = False) -> QuantizedTensor4:
    """(L, K, N) -> nibble-packed int4 with (L, K/G, N) group scales, absmax
    round-to-nearest. mse=True searches 11 scales in [0.75, 1.0]·absmax per
    (group, channel) for the least squared dequantization error of the
    group, as the JAX package's `_quantize_stacked_int4`."""
    l, k, n = w.shape
    if k % group or n % 2:
        raise ValueError(f"int4 needs K % group == 0 and even N, got {(k, n)}"
                         f" with group {group}")
    wf = w.float().reshape(l, k // group, group, n)
    amax = wf.abs().amax(dim=2, keepdim=True)
    s = amax.clamp_min(1e-8) / 7.0
    if mse:
        cands = torch.tensor(np.linspace(0.75, 1.0, 11), dtype=torch.float32)
        errs = []
        for c in cands:
            sc = s * c
            q = torch.round(wf / sc).clamp_(-8, 7)
            errs.append(((wf - q * sc) ** 2).sum(dim=2, keepdim=True))
        s = s * cands.to(s.device)[torch.stack(errs).argmin(dim=0)]
    q = torch.round(wf / s).clamp_(-8, 7).to(torch.int8).reshape(l, k, n)
    packed = (q[..., :n // 2] & 0x0F) | (q[..., n // 2:] << 4)
    return QuantizedTensor4(packed, s[:, :, 0, :])


def quantize_params_int4(params: dict, mse: bool = False) -> dict:
    """INT4 (W4A16) block weights, groups of `int4_group_size`; embeddings,
    norms and the lm_head as in the INT8 format (the lm_head int8). An INT8
    tree is dequantized first. MoE expert stacks (L, E, K, N) stay INT8, as
    in the JAX package: the INT4 kernel path is dense-only."""
    from ..kernels.fused_decode import int4_group_size

    blocks = {}
    for name, w in params["blocks"].items():
        if name not in _QUANT_LEAVES:
            blocks[name] = w
            continue
        if isinstance(w, QuantizedTensor):
            w = w.dequantize(torch.float32)
        if w.dim() != 3:
            blocks[name] = QuantizedTensor(*quantize_int8(w, axis=-2))
            continue
        _, k, n = w.shape
        blocks[name] = _quantize_stacked_int4(w, int4_group_size(k, n), mse)
    lm = params["lm_head"]
    if not isinstance(lm, QuantizedTensor):
        lm = QuantizedTensor(*quantize_int8(lm, axis=0))
    return {"embed": params["embed"], "norm": params["norm"],
            "blocks": blocks, "lm_head": lm}


def init_params_int4(generator: torch.Generator, cfg: ModelConfig,
                     device=None) -> dict:
    """Initialize a model directly in the INT4 format on `device` (default:
    the generator's device): packed bytes uniform in [-128, 127] (two
    uniform nibbles), group scales set so the dequantized std is
    fan_in**-0.5, an int8 lm_head, as the JAX package's init_params_int4
    (the bits differ: torch and jax draw different numbers)."""
    from ..kernels.fused_decode import int4_group_size

    device = torch.device(device) if device is not None else generator.device
    d, f, v = cfg.hidden_dim, cfg.intermediate_dim, cfg.vocab_size
    hd, L = cfg.head_dim, cfg.num_layers
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    dtype = torch_dtype(cfg)

    def qw4(k, n, fan_in):
        packed = torch.randint(-128, 128, (L, k, n // 2), dtype=torch.int8,
                               generator=generator, device=device)
        # 4.6 ~ std of a uniform int4 nibble
        s = torch.full((L, k // int4_group_size(k, n), n),
                       (fan_in ** -0.5) / 4.6, dtype=torch.float32,
                       device=device)
        return QuantizedTensor4(packed, s)

    blocks = {
        "ln1": torch.ones((L, d), dtype=dtype, device=device),
        "wqkv": qw4(d, qkv_out, d),
        "wo": qw4(cfg.num_heads * hd, d, d),
        "ln2": torch.ones((L, d), dtype=dtype, device=device),
        "w_gate_up": qw4(d, 2 * f, d),
        "w_down": qw4(f, d, f),
    }
    emb = (torch.randn((v, d), generator=generator, device=device)
           * (d ** -0.5)).to(dtype)
    lm_q = torch.randint(-127, 128, (d, v), dtype=torch.int8,
                         generator=generator, device=device)
    lm_s = torch.full((1, v), (d ** -0.5) / 73.9, dtype=torch.float32,
                      device=device)
    return {"embed": emb, "blocks": blocks,
            "norm": torch.ones((d,), dtype=dtype, device=device),
            "lm_head": QuantizedTensor(lm_q, lm_s)}


def quantized_param_bytes(params: dict) -> dict:
    """Bytes by precision class (the decode-bandwidth denominator of the
    roofline model): int8 and int4 leaves count their values and scales."""
    int8 = int4 = other = 0

    def leaves(tree):
        if isinstance(tree, dict):
            for t in tree.values():
                yield from leaves(t)
        else:
            yield tree

    for leaf in leaves(params):
        if isinstance(leaf, (QuantizedTensor, QuantizedTensor4)):
            n = sum(t.numel() * t.element_size() for t in leaf)
            if isinstance(leaf, QuantizedTensor4):
                int4 += n
            else:
                int8 += n
        else:
            other += leaf.numel() * leaf.element_size()
    return {"int8_bytes": int8, "int4_bytes": int4, "other_bytes": other,
            "total_bytes": int8 + int4 + other}
