"""Shared pieces of the parity tests between physics_llm_inference_tpu (JAX,
the reference) and physics_llm_inference_tpu_torch (the port).

Both packages get the same numpy arrays; JAX stays on the CPU. Tolerances
are stated here once, per dtype, and every parity test reads them.
"""
from __future__ import annotations

import jax
import numpy as np
import torch

# Logits/activations of the two packages on the same weights and inputs.
# fp32: only the order of f32 sums differs. bf16: both sides round
# activations to bf16 after every op, but not at the same places (e.g. XLA
# may fuse an f32 epilogue that torch rounds, or the reverse), so single
# bf16 ulps (2^-8 relative) differ and propagate through the layers.
TOL = {
    "float32": dict(atol=1e-4, rtol=1e-4),
    "bfloat16": dict(atol=6e-2, rtol=5e-2),
}


def assert_close(got, want, dtype: str, err_msg: str = ""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               err_msg=err_msg, **TOL[dtype])


def to_numpy(tree):
    """A JAX pytree with numpy leaves (QuantizedTensor/KVCache stay typed)."""
    return jax.tree_util.tree_map(np.asarray, tree)


def t2n(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()
