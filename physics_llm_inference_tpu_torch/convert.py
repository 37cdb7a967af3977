"""Carry JAX-package weights and KV caches over to the port.

`params_from_jax` takes the JAX parameter pytree with numpy leaves (e.g.
`jax.tree_util.tree_map(np.asarray, params)`) and returns the port's dict
with the same keys and layouts. Quantized leaves are recognised by their
`.q`/`.s` attributes, so this module never imports jax. `kv_from_jax`
carries a slot KV cache, `paged_kv_from_jax` the paged engine's pools.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.quant import QuantizedTensor
from .models.transformer import QuantKV
from .runtime.kv_cache import KVCache


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: torch cannot view it
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _is_quant(leaf) -> bool:
    return hasattr(leaf, "q") and hasattr(leaf, "s")


def _leaf(leaf, device, dtype):
    if _is_quant(leaf):
        # int8 values and f32 scales keep their dtypes and layouts
        return QuantizedTensor(_tensor(leaf.q, device), _tensor(leaf.s, device))
    return _tensor(leaf, device, dtype)


def params_from_jax(tree: dict, device="cpu", dtype=None) -> dict:
    """JAX param pytree (numpy leaves) -> the port's parameter dict.
    `dtype` casts the floating non-quantized leaves (embed, norms, dense
    weights); None keeps their dtypes."""
    return {
        "embed": _leaf(tree["embed"], device, dtype),
        "norm": _leaf(tree["norm"], device, dtype),
        "lm_head": _leaf(tree["lm_head"], device, dtype),
        "blocks": {k: _leaf(v, device, dtype)
                   for k, v in tree["blocks"].items()},
    }


def kv_from_jax(cache, device="cpu") -> KVCache:
    """A JAX KVCache with numpy leaves -> the port's KVCache.
    QuantKV keeps its flat int8 values and transposed f32 scales."""
    def conv(part):
        if _is_quant(part):
            return QuantKV(_tensor(part.q, device), _tensor(part.s, device))
        return _tensor(part, device)

    return KVCache(k=conv(cache.k), v=conv(cache.v), length=int(cache.length))


def paged_kv_from_jax(k_pools, v_pools=None, device="cpu"):
    """The paged engine's pools (numpy leaves) -> the port's (k, v): the
    merged QuantKV pools (L, NB+1, 2, BS, Hkv·hd) int8 and
    (L, NB+1, 2, Hkv, BS) f32 with v None, or the plain
    (L, NB+1, BS, Hkv, hd) K and V pools."""
    if _is_quant(k_pools):
        return QuantKV(_tensor(k_pools.q, device),
                       _tensor(k_pools.s, device)), None
    return _tensor(k_pools, device), _tensor(v_pools, device)
