"""Carry JAX-package weights and KV caches over to the port.

`params_from_jax` takes the JAX parameter pytree with numpy leaves (e.g.
`jax.tree_util.tree_map(np.asarray, params)`) and returns the port's dict
with the same keys and layouts. Quantized leaves are recognised by their
`.q`/`.s` attributes, so this module never imports jax: a JAX
`QuantizedTensor4` (by its class name) becomes the port's
`QuantizedTensor4`, a `QuantizedTensor` the port's `QuantizedTensor`, and a
leaf whose shapes fit neither layout raises. `kv_from_jax` carries a slot
KV cache, `paged_kv_from_jax` the paged engine's pools.
Each puts its tensors on the card (`device=None` means "cuda") unless the
caller names another device, e.g. `device="cpu"`.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.quant import QuantizedTensor, QuantizedTensor4
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
    return t.to("cuda" if device is None else device)


def _is_quant(leaf) -> bool:
    return hasattr(leaf, "q") and hasattr(leaf, "s")


def _quant_leaf(leaf, device):
    """A quantized JAX leaf as the port's type, its int8 values and f32
    scales in their dtypes and layouts. INT8: q (..., K, N), s (..., 1, N)
    (or (1, N) for a 2-D q). INT4: packed q (..., K, N/2), s (..., K/G, N)
    with G dividing K. Anything else raises here, not at first use."""
    int4 = type(leaf).__name__ == "QuantizedTensor4"
    q, s = np.asarray(leaf.q), np.asarray(leaf.s)
    ok = (q.dtype == np.int8 and s.dtype == np.float32 and q.ndim >= 2
          and s.ndim == q.ndim and s.shape[:-2] == q.shape[:-2])
    if ok and int4:
        ok = (s.shape[-1] == 2 * q.shape[-1] and s.shape[-2] > 0
              and q.shape[-2] % s.shape[-2] == 0)
    elif ok:
        ok = s.shape[-1] == q.shape[-1] and s.shape[-2] == 1
    if not ok:
        raise ValueError(f"{type(leaf).__name__} with q {q.dtype}{q.shape} and "
                         f"s {s.dtype}{s.shape} fits neither the int8 nor the "
                         "int4 layout")
    cls = QuantizedTensor4 if int4 else QuantizedTensor
    return cls(_tensor(q, device), _tensor(s, device))


def _leaf(leaf, device, dtype):
    if _is_quant(leaf):
        return _quant_leaf(leaf, device)
    return _tensor(leaf, device, dtype)


def params_from_jax(tree: dict, device=None, dtype=None) -> dict:
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


def kv_from_jax(cache, device=None) -> KVCache:
    """A JAX KVCache with numpy leaves -> the port's KVCache.
    QuantKV keeps its flat int8 values and transposed f32 scales."""
    def conv(part):
        if _is_quant(part):
            return QuantKV(_tensor(part.q, device), _tensor(part.s, device))
        return _tensor(part, device)

    return KVCache(k=conv(cache.k), v=conv(cache.v), length=int(cache.length))


def paged_kv_from_jax(k_pools, v_pools=None, device=None):
    """The paged engine's pools (numpy leaves) -> the port's (k, v): the
    merged QuantKV pools (L, NB+1, 2, BS, Hkv·hd) int8 and
    (L, NB+1, 2, Hkv, BS) f32 with v None, or the plain
    (L, NB+1, BS, Hkv, hd) K and V pools."""
    if _is_quant(k_pools):
        return QuantKV(_tensor(k_pools.q, device),
                       _tensor(k_pools.s, device)), None
    return _tensor(k_pools, device), _tensor(v_pools, device)
