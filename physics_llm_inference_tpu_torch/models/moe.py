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
  captured in a CUDA graph; the dropless path below, which reads each
  expert's row count, is never taken while a graph is captured.
- DeepSeek-V2's router (`MoEConfig.router_f32`, `norm_topk_prob`,
  `routed_scaling_factor`; the model's `MoEGate`, topk_method "greedy"):
  the gate's product in f32, and the top-k weights left as they are, times
  the scaling factor, instead of renormalised. The JAX package has no such
  router.
The expert products are what the JAX package computes outside any Pallas
kernel. Where the slots and stacks fit the grouped kernels
(`kernels/moe_experts`: bf16 activations, INT8 stacks, at most 64 slots an
expert, as in a decode step), those stream each expert's int8 weights once,
scale the f32 sums and work only on each expert's claimed slots (its count
of pairs from the dispatch's running count, clamped to C, on the device);
the slots past the count are neither zeroed nor read. Where the capacity
admits every pair and exceeds those 64 slots (a dropless prefill), the grid
is skipped: the pairs are sorted by expert and each expert's SwiGLU runs
over its own rows only, one grouped product a matrix (`_dropless`), so the
transient memory grows with the pairs (T·K rows), not with the grid (E·C
rows, E·T when dropless). Elsewhere (a capacity below T, slots or stacks
the kernels do not take, a dropless layer while a graph is captured) each
stack is dequantized into x's dtype, then batched products (`torch.bmm`)
and silu(h1) * h3 over the grid.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.moe_experts import MAX_SLOTS, moe_experts
from ..utils import tracing
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


def router(x: torch.Tensor, gate: torch.Tensor, top_k: int,
           norm: bool = True, f32: bool = False, scaling: float = 1.0):
    """Linear gate in x's dtype (in f32 with `f32`) -> f32 softmax -> top-k
    (ties to the lower expert index) -> renormalized weights (with `norm`;
    else the top-k probabilities times `scaling`). x: (T, D); returns
    (weights (T, K) f32, indices (T, K) int64, probs (T, E) f32)."""
    logits = x.float() @ gate.float() if f32 else x @ gate
    probs = torch.softmax(logits.float(), dim=-1)
    weights, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, indices = weights[:, :top_k], indices[:, :top_k]
    if not norm:
        return weights * scaling, indices, probs
    return weights / weights.sum(dim=-1, keepdim=True), indices, probs


def _dispatch_slots(indices: torch.Tensor, weights: torch.Tensor,
                    num_experts: int, capacity: int,
                    valid: torch.Tensor | None = None, counts: bool = False):
    """Each (token, choice) pair's slot in the flat (E*C + 1) grid: row
    e*C + p for the p-th pair routed to expert e (token-major, choice-minor
    order), or the sink row E*C when the pair is past capacity or its token
    is not `valid`. Returns (slot (T, K) int64, combine weights (T, K) f32,
    0 where the pair is not routed): the JAX package's (T, E, C) dispatch
    and combine masks hold a 1 and the weight at (t, slot // C, slot % C)
    for each routed pair. With `counts`, also each expert's slots claimed,
    (E,) int64: its valid pairs clamped to C, so its claimed slots are rows
    0..count-1 of its C."""
    t, k = indices.shape
    experts = torch.arange(num_experts, device=indices.device)
    onehot = (indices[..., None] == experts).to(torch.int32)     # (T, K, E)
    if valid is not None:
        onehot = onehot * valid.reshape(t, 1, 1).to(torch.int32)
    flat = onehot.reshape(t * k, num_experts).t().contiguous()  # (E, T*K)
    # the running count along each expert's row: an innermost-dim scan,
    # which CUDA runs per row in parallel (over dim 0 of (T*K, E) it is a
    # serial loop over the tokens a column)
    running = flat.cumsum(dim=1)
    pos_in_expert = running - flat
    pos = (flat * pos_in_expert).sum(dim=0).reshape(t, k)
    routed = (flat.sum(dim=0).reshape(t, k) > 0) & (pos < capacity)
    slot = torch.where(routed, indices * capacity + pos,
                       num_experts * capacity)
    combine = torch.where(routed, weights, torch.zeros_like(weights))
    if counts:
        return slot, combine, running[:, -1].clamp(max=capacity)
    return slot, combine


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

    weights, indices, probs = router(xt, params["gate"], k,
                                     norm=moe.norm_topk_prob,
                                     f32=moe.router_f32,
                                     scaling=moe.routed_scaling_factor)
    if valid is not None:
        valid = valid.expand(orig_shape[:-1]).reshape(t)
    stacks = [params[n] for n in ("w1", "w3", "w2")]
    grouped = _grouped(x, stacks, capacity)
    slot, combine, *count = _dispatch_slots(indices, weights, e, capacity,
                                            valid, counts=grouped)
    if capacity >= t and capacity > MAX_SLOTS and not _capturing(x):
        out = _dropless(xt, stacks, indices, combine, valid, e)
        out = out.to(x.dtype).reshape(orig_shape)
        return out, (weights, indices, probs, slot, capacity, valid)

    # gather token slots: (E, C, D); the sink row (past the grid) takes the
    # dropped pairs; slots nobody claims are 0, or, on the grouped route,
    # which reads none past an expert's count, left unwritten
    grid = (xt.new_empty if grouped else xt.new_zeros)((e * capacity + 1, d))
    grid.index_copy_(0, slot.reshape(-1),
                     xt.repeat_interleave(k, dim=0))
    expert_in = grid[:-1].view(e, capacity, d)
    if grouped:
        expert_out = moe_experts(expert_in, *stacks, *count)
    else:
        w1, w3, w2 = (_dequantize(w, x.dtype) for w in stacks)
        hidden = F.silu(torch.bmm(expert_in, w1)) * torch.bmm(expert_in, w3)
        expert_out = torch.bmm(hidden, w2)
    expert_out = expert_out.reshape(e * capacity, d)
    # weighted combine in f32; a dropped pair's weight is 0
    picked = expert_out[slot.clamp(max=e * capacity - 1)].float()
    out = (combine[..., None] * picked).sum(dim=1)
    out = out.to(x.dtype).reshape(orig_shape)
    return out, (weights, indices, probs, slot, capacity, valid)


def _capturing(x: torch.Tensor) -> bool:
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


def _dropless(xt, stacks, indices, combine, valid, e: int) -> torch.Tensor:
    """The expert products over the routed (token, choice) pairs alone,
    when no pair is dropped: the pairs sorted by expert (stable, so
    token-major within an expert; pads' pairs last, in no expert), one
    grouped product a matrix over the experts' runs of rows
    (`torch._grouped_mm`, each stack dequantized into x's dtype, as the
    grid path dequantizes them), the rows put back at their pairs, and the
    grid path's combine (the K weighted f32 rows of a token summed in
    choice order). Every buffer has the T·K rows of every pair, so its
    size does not move with the routing. Reads each expert's row count on
    the host, once, and records them in a `moe.prefill_route` span
    (attributes: the largest and the mean rows an expert, the experts and
    the routed pairs). Returns (T, D) f32."""
    t, k = indices.shape
    d = xt.shape[1]
    t0 = tracing.now()
    flat = indices.reshape(-1)
    if valid is not None:
        flat = torch.where(valid.repeat_interleave(k), flat,
                           torch.full_like(flat, e))
    order = torch.sort(flat, stable=True).indices
    count = torch.bincount(flat, minlength=e + 1)[:e]
    offs = count.cumsum(0).to(torch.int32)
    counts = count.tolist()
    pairs = sum(counts)
    rows = xt[order // k]
    w1, w3, w2 = (_dequantize(w, xt.dtype) for w in stacks)
    h = F.silu(torch._grouped_mm(rows, w1, offs=offs)) * \
        torch._grouped_mm(rows, w3, offs=offs)
    ys = torch._grouped_mm(h, w2, offs=offs)
    ys[pairs:] = 0          # pads' rows: written by no group
    picked = torch.empty_like(ys)
    picked[order] = ys
    out = (combine[..., None] * picked.view(t, k, d).float()).sum(dim=1)
    tracing.record("moe.prefill_route", t0, attrs={
        "rows_max": max(counts), "rows_mean": pairs / e, "experts": e,
        "pairs": pairs})
    return out


def _grouped(x, stacks, capacity: int) -> bool:
    """Whether the grouped kernels take the expert products: bf16
    activations, all three stacks INT8, at most MAX_SLOTS slots an expert
    (decode steps; a prefill's capacity is larger), and widths whose rows
    are whole 16-byte vectors, as the kernels' TMA reads them."""
    if x.dtype != torch.bfloat16 or capacity > MAX_SLOTS:
        return False
    if not all(isinstance(w, QuantizedTensor) for w in stacks):
        return False
    d, f = stacks[0].q.shape[-2:]
    return d % 16 == 0 and f % 16 == 0


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
