"""FFN variants (counterpart: physics_llm_inference_tpu/ops/ffn.py:15-32).

The fused variant concatenates the gate and up projections into one
(D, 2F) matmul and splits the result. Plain torch, as the JAX package
leaves these to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ffn_relu(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """relu(x @ w_up) @ w_down."""
    return F.relu(x @ w_up) @ w_down


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """(silu(x @ w_gate) * (x @ w_up)) @ w_down."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def fused_swiglu(x: torch.Tensor, w_gate_up: torch.Tensor,
                 w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU with the fused gate+up weight (D, 2F), split after one
    matmul."""
    gate, up = (x @ w_gate_up).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ w_down
