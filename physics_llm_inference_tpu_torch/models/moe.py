"""Mixture-of-experts layer: router + static-capacity expert dispatch
(counterpart: physics_llm_inference_tpu/models/moe.py).

The routing is the JAX package's GShard/Mesh-TF scheme, integer for
integer: each token's top-k choices claim a slot in a fixed (E, C) capacity
grid, C = max(1, int(capacity_factor * T * K / E)), in token-major,
choice-minor order (a cumsum over the (T*K, E) one-hot); pairs past an
expert's capacity are dropped, and `valid` takes padding out of routing
(a pad claims no slot and its output row is 0).

What differs from the JAX package, on purpose:
- Top-k is a stable descending sort: ties go to the lower expert index, as
  `jax.lax.top_k` breaks them (`torch.topk` does not). Equal probabilities
  are common in bf16, where the router's logits are rounded before the
  softmax.
- Dispatch and combine are an index scatter into, and a gather from, a flat
  (E*C + 1, D) grid whose last row takes the dropped pairs, where JAX
  multiplies (T, E, C) one-hot masks. The one-hot product has one nonzero
  term times 1.0, so the scatter is exact, and the combine sums the same K
  weighted f32 rows.
- Nothing is read from the device on the host (`dropped` stays a tensor,
  the capacity is a Python int of the static shapes), so the layer can be
  captured in a CUDA graph.
The expert products are what the JAX package computes outside any Pallas
kernel: each INT8 stack dequantized into x's dtype, then batched products
(`torch.bmm`) and silu(h1) * h3.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig, torch_dtype
from .quant import QuantizedTensor


def init_moe_params(generator: torch.Generator, cfg: ModelConfig,
                    moe: MoEConfig, dtype=None, device=None) -> dict:
    """Router gate (D, E) + per-expert SwiGLU stacks (E, ...), weights
    ~ N(0, 1/fan_in), on `device` (default: the generator's device)."""
    device = torch.device(device) if device is not None else generator.device
    dtype = dtype or torch_dtype(cfg)
    d, f, e = cfg.hidden_dim, cfg.intermediate_dim, moe.num_experts

    def w(shape, fan):
        return (torch.randn(shape, generator=generator, device=device)
                * fan ** -0.5).to(dtype)

    return {"gate": w((d, e), d), "w1": w((e, d, f), d),
            "w3": w((e, d, f), d), "w2": w((e, f, d), f)}


def router(x: torch.Tensor, gate: torch.Tensor, top_k: int):
    """Linear gate in x's dtype -> f32 softmax -> top-k (ties to the lower
    expert index) -> renormalized weights. x: (T, D); returns (weights
    (T, K) f32, indices (T, K) int64, probs (T, E) f32)."""
    probs = torch.softmax((x @ gate).float(), dim=-1)
    weights, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, indices = weights[:, :top_k], indices[:, :top_k]
    return weights / weights.sum(dim=-1, keepdim=True), indices, probs


def _dispatch_slots(indices: torch.Tensor, weights: torch.Tensor,
                    num_experts: int, capacity: int,
                    valid: torch.Tensor | None = None):
    """Each (token, choice) pair's slot in the flat (E*C + 1) grid: row
    e*C + p for the p-th pair routed to expert e (token-major, choice-minor
    order), or the sink row E*C when the pair is past capacity or its token
    is not `valid`. Returns (slot (T, K) int64, combine weights (T, K) f32,
    0 where the pair is not routed): the JAX package's (T, E, C) dispatch
    and combine masks hold a 1 and the weight at (t, slot // C, slot % C)
    for each routed pair."""
    t, k = indices.shape
    experts = torch.arange(num_experts, device=indices.device)
    onehot = (indices[..., None] == experts).to(torch.int32)     # (T, K, E)
    if valid is not None:
        onehot = onehot * valid.reshape(t, 1, 1).to(torch.int32)
    flat = onehot.reshape(t * k, num_experts).t().contiguous()  # (E, T*K)
    # the running count along each expert's row: an innermost-dim scan,
    # which CUDA runs per row in parallel (over dim 0 of (T*K, E) it is a
    # serial loop over the tokens a column)
    pos_in_expert = flat.cumsum(dim=1) - flat
    pos = (flat * pos_in_expert).sum(dim=0).reshape(t, k)
    routed = (flat.sum(dim=0).reshape(t, k) > 0) & (pos < capacity)
    slot = torch.where(routed, indices * capacity + pos,
                       num_experts * capacity)
    return slot, torch.where(routed, weights, torch.zeros_like(weights))


def moe_layer(x: torch.Tensor, params: dict, moe: MoEConfig,
              valid: torch.Tensor | None = None):
    """Routed MoE forward over (B, S, D) or (T, D): per-expert SwiGLU on
    the capacity grid's slots, weighted combine. `valid` (broadcastable to
    x's token dims) takes padding out of routing. Returns (output, aux):
    aux holds the router's probs, indices and weights, the capacity (int)
    and `dropped`, the (token, choice) pairs past capacity (a 0-d f32
    tensor)."""
    out, (weights, indices, probs, slot, capacity, valid) = _routed(
        x, params, moe, valid)
    k = moe.num_experts_per_tok
    routed = (slot < moe.num_experts * capacity).sum().float()
    total = valid.float().sum() * k if valid is not None else slot.numel()
    aux = {"probs": probs, "indices": indices, "weights": weights,
           "capacity": capacity, "dropped": total - routed}
    return out, aux


def moe_forward(x: torch.Tensor, params: dict, moe: MoEConfig,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """`moe_layer`'s output alone: the model's FFN, which launches none of
    the ops that only build aux."""
    return _routed(x, params, moe, valid)[0]


def _routed(x, params, moe, valid):
    """The routed forward: (output, (weights, indices, probs, slot,
    capacity, valid flattened to (T,) or None))."""
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    e, k = moe.num_experts, moe.num_experts_per_tok
    capacity = max(1, int(moe.capacity_factor * t * k / e))

    weights, indices, probs = router(xt, params["gate"], k)
    if valid is not None:
        valid = valid.expand(orig_shape[:-1]).reshape(t)
    slot, combine = _dispatch_slots(indices, weights, e, capacity, valid)

    # gather token slots: (E, C, D); the sink row (past the grid) takes the
    # dropped pairs, and slots nobody claims stay 0
    grid = xt.new_zeros((e * capacity + 1, d))
    grid.index_copy_(0, slot.reshape(-1),
                     xt.repeat_interleave(k, dim=0))
    expert_in = grid[:-1].view(e, capacity, d)
    w1, w3, w2 = (_dequantize(params[n], x.dtype) for n in ("w1", "w3", "w2"))
    hidden = F.silu(torch.bmm(expert_in, w1)) * torch.bmm(expert_in, w3)
    expert_out = torch.bmm(hidden, w2).reshape(e * capacity, d)
    # weighted combine in f32; a dropped pair's weight is 0
    picked = expert_out[slot.clamp(max=e * capacity - 1)].float()
    out = (combine[..., None] * picked).sum(dim=1)
    out = out.to(x.dtype).reshape(orig_shape)
    return out, (weights, indices, probs, slot, capacity, valid)


def _dequantize(w, dtype):
    """An INT8 expert stack (models/quant.py quantizes moe_w1/w3/w2) in the
    compute dtype; a plain stack as it is."""
    return w.dequantize(dtype) if isinstance(w, QuantizedTensor) else w


def expert_load_balance_loss(probs: torch.Tensor, indices: torch.Tensor,
                             num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e(avg_prob_e * token_frac_e)."""
    experts = torch.arange(num_experts, device=indices.device)
    onehot = (indices[..., None] == experts).float()            # (T, K, E)
    token_frac = onehot.sum(dim=1).mean(dim=0)
    return num_experts * (probs.mean(dim=0) * token_frac).sum()
