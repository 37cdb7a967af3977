"""Dense and INT8 KV caches (counterpart: physics_llm_inference_tpu/runtime/kv_cache.py).

Caches are stacked over layers and preallocated at a fixed capacity; the
model writes them IN PLACE (models/transformer.py `_cache_write`). A
multi-head latent attention config caches the INT8 latent instead
(models/mla.py `LatentKV`, in `k`; `v` is None).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.config import ModelConfig, torch_dtype
from ..models.mla import LatentKV, latent_bytes_per_token
from ..models.transformer import KVSlice, QuantKV


def _is_int8(dtype) -> bool:
    return dtype is torch.int8 or dtype == "int8"


class KVCache(NamedTuple):
    """Stacked per-layer K/V + fill length.

    dtype int8 builds the QuantKV format: values FLAT (L, B, S, Hkv·hd) int8
    and scales TRANSPOSED (L, B, Hkv, S) f32. Otherwise (L, B, S, Hkv, hd) in
    `dtype` (default: the model dtype). An MLA config takes int8 only: `k`
    is a LatentKV (codes (L, B, S, R + dr), scales (L, B, 2, S)), `v`
    None."""

    k: torch.Tensor | QuantKV | LatentKV
    v: torch.Tensor | QuantKV | None
    length: int

    @classmethod
    def create(cls, cfg: ModelConfig, batch_size: int, max_seq_len: int,
               dtype=None, device=None) -> "KVCache":
        L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        if cfg.mla:
            if dtype is None or not _is_int8(dtype):
                raise ValueError("an MLA model caches the INT8 latent: pass "
                                 "kv_dtype=torch.int8")
            width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            return cls(k=LatentKV(
                q=torch.zeros((L, batch_size, max_seq_len, width),
                              dtype=torch.int8, device=device),
                s=torch.zeros((L, batch_size, 2, max_seq_len),
                              dtype=torch.float32, device=device)),
                v=None, length=0)
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

    @classmethod
    def from_slice(cls, s: KVSlice) -> "KVCache":
        return cls(k=s.k, v=s.v, length=s.start)

    @property
    def max_seq_len(self) -> int:
        k = self.k.q if isinstance(self.k, (QuantKV, LatentKV)) else self.k
        return k.shape[2]

    def memory_bytes(self) -> int:
        """Total bytes of both caches incl. quant scales."""
        parts = [p for kv in (self.k, self.v) if kv is not None
                 for p in (kv if isinstance(kv, (QuantKV, LatentKV))
                           else (kv,))]
        return sum(p.numel() * p.element_size() for p in parts)

    @property
    def kind(self) -> str:
        """"latent_int8", "int8" or the dtype's name."""
        if isinstance(self.k, LatentKV):
            return "latent_int8"
        if isinstance(self.k, QuantKV):
            return "int8"
        return str(self.k.dtype).replace("torch.", "")

    def bytes_per_token(self, cfg: ModelConfig) -> int:
        """Cache bytes a token holds over every layer, scales included."""
        if isinstance(self.k, LatentKV):
            return cfg.num_layers * latent_bytes_per_token(cfg)
        per = cfg.num_kv_heads * cfg.head_dim
        if isinstance(self.k, QuantKV):
            return cfg.num_layers * 2 * (per + 4 * cfg.num_kv_heads)
        return cfg.num_layers * 2 * per * self.k.element_size()


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
