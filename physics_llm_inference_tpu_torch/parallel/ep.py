"""Expert parallelism: experts sharded over a mesh axis, capacity grids
exchanged by all-to-all (counterpart: physics_llm_inference_tpu/parallel/
ep.py).

Each rank routes its own token slice through the replicated gate into a
full (E, C, D) capacity grid (models/moe.py's dispatch, C from the LOCAL
token count), `Mesh.all_to_all` delivers each expert's slots to the rank
that owns it, that rank runs its experts' SwiGLU, and the reverse
all-to-all brings the results back for the weighted combine. So EP equals
the single-device layer applied to each rank's slice, and the
single-device layer over all tokens only where no token is dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.config import MoEConfig
from ..models.moe import _dequantize, _dispatch_slots, router
from ..models.quant import QuantizedTensor


def _local_experts(w, lo: int, hi: int):
    """Experts [lo, hi) of a stack (E, ...), plain or INT8."""
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(w.q[lo:hi], w.s[lo:hi])
    return w[lo:hi]


def moe_layer_ep(mesh, x: torch.Tensor, params: dict, moe: MoEConfig,
                 axis: str = "expert") -> torch.Tensor:
    """Expert-parallel MoE forward over (T, D) tokens, the same on every
    rank of `axis`. params as from init_moe_params (gate (D, E); w1/w3
    (E, D, F), w2 (E, F, D), plain or INT8): this rank routes tokens
    [i·T/n, (i+1)·T/n) and runs experts [i·E/n, (i+1)·E/n), each INT8 stack
    dequantized for those experts alone. Returns the (T, D) output,
    gathered over `axis`."""
    if moe.router_f32 or not moe.norm_topk_prob:
        raise NotImplementedError(
            "expert parallelism (parallel/ep.py) does not take DeepSeek-V2's "
            "router (the MLA models' f32 gate, top-k without "
            "renormalisation) or shared experts yet")
    n, i = mesh.size(axis), mesh.index(axis)
    e, k = moe.num_experts, moe.num_experts_per_tok
    if e % n:
        raise ValueError(f"num_experts {e} must divide the {axis} axis {n}")
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} tokens must divide the {axis} axis "
                         f"{n}")
    t_loc, d = x.shape[0] // n, x.shape[1]
    el = e // n
    xl = x[i * t_loc:(i + 1) * t_loc]
    capacity = max(1, int(moe.capacity_factor * t_loc * k / e))
    weights, indices, _ = router(xl, params["gate"], k)
    slot, combine = _dispatch_slots(indices, weights, e, capacity)
    grid = xl.new_zeros((e * capacity + 1, d))
    grid.index_copy_(0, slot.reshape(-1), xl.repeat_interleave(k, dim=0))
    expert_in = grid[:-1].view(e, capacity, d)
    # (E, C, D) -> (E/n, n·C, D): expert chunks out, token-source chunks in
    local_in = mesh.all_to_all(expert_in, axis, split_dim=0, concat_dim=1)
    w1, w3, w2 = (_dequantize(_local_experts(params[nm], i * el,
                                             (i + 1) * el), x.dtype)
                  for nm in ("w1", "w3", "w2"))
    hidden = F.silu(torch.bmm(local_in, w1)) * torch.bmm(local_in, w3)
    local_out = torch.bmm(hidden, w2)
    # reverse: (E/n, n·C, D) -> (E, C, D) back at the token owner
    expert_out = mesh.all_to_all(local_out, axis, split_dim=1,
                                 concat_dim=0).reshape(e * capacity, d)
    picked = expert_out[slot.clamp(max=e * capacity - 1)].float()
    out = (combine[..., None] * picked).sum(dim=1).to(x.dtype)
    return mesh.all_gather(out, axis, dim=0)
