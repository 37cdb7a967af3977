"""Dense and INT8 KV caches (counterpart: physics_llm_inference_tpu/runtime/kv_cache.py).

Caches are stacked over layers and preallocated at a fixed capacity; the
model writes them IN PLACE (models/transformer.py `_cache_write`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.config import ModelConfig, torch_dtype
from ..models.transformer import KVSlice, QuantKV


def _is_int8(dtype) -> bool:
    return dtype is torch.int8 or dtype == "int8"


class KVCache(NamedTuple):
    """Stacked per-layer K/V + fill length.

    dtype int8 builds the QuantKV format: values FLAT (L, B, S, Hkv·hd) int8
    and scales TRANSPOSED (L, B, Hkv, S) f32. Otherwise (L, B, S, Hkv, hd) in
    `dtype` (default: the model dtype)."""

    k: torch.Tensor | QuantKV
    v: torch.Tensor | QuantKV
    length: int

    @classmethod
    def create(cls, cfg: ModelConfig, batch_size: int, max_seq_len: int,
               dtype=None, device=None) -> "KVCache":
        L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        if dtype is not None and _is_int8(dtype):
            def mk():
                return QuantKV(
                    q=torch.zeros((L, batch_size, max_seq_len, hkv * hd),
                                  dtype=torch.int8, device=device),
                    s=torch.zeros((L, batch_size, hkv, max_seq_len),
                                  dtype=torch.float32, device=device))
            return cls(k=mk(), v=mk(), length=0)
        dtype = dtype or torch_dtype(cfg)
        shape = (L, batch_size, max_seq_len, hkv, hd)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)

    def as_slice(self) -> KVSlice:
        return KVSlice(self.k, self.v, self.length)


def calculate_kv_cache_size(batch_size: int, seq_len: int, num_layers: int,
                            num_kv_heads: int, head_dim: int,
                            dtype_bytes: int = 2) -> dict:
    """Analytic KV sizing: per-token-per-layer, per-token and total bytes."""
    per_token_per_layer = 2 * num_kv_heads * head_dim * dtype_bytes
    per_token = per_token_per_layer * num_layers
    total = per_token * batch_size * seq_len
    return {
        "bytes_per_token_per_layer": per_token_per_layer,
        "bytes_per_token": per_token,
        "total_bytes": total,
        "total_gb": total / 1e9,
    }
