"""INT8 weight-only model quantization (counterpart: physics_llm_inference_tpu/models/quant.py).

Every block matmul weight (and the lm_head) becomes a QuantizedTensor: int8
values plus per-output-channel f32 scales. Stacked block weights keep the
JAX layout: q (L, K, N) int8, s (L, 1, N) f32; the lm_head is q (D, V),
s (1, V). Embeddings and norms stay in the model dtype. INT4 is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.quant import quantize_int8
from .config import ModelConfig, torch_dtype


class QuantizedTensor(NamedTuple):
    """int8 values + broadcastable f32 scale (reduction axes have size 1)."""

    q: torch.Tensor
    s: torch.Tensor

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.q.float() * self.s).to(dtype)


_QUANT_LEAVES = ("wqkv", "wo", "w_gate_up", "w_down")


def quantize_params_int8(params: dict) -> dict:
    """Quantize all block matmul weights and the lm_head."""
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
