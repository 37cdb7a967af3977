"""Ring attention: sequence-parallel GQA attention over a mesh axis
(counterpart: physics_llm_inference_tpu/parallel/ring_attention.py).

Each rank keeps its query chunk and the K/V chunks go round the ring
(`Mesh.ring_shift`: batch_isend_irecv to the next index, from the
previous), while the online-softmax state (m, l, o) accumulates in f32 on
the rank: the flash recurrence applied across ranks. Plain torch, as the
JAX module is plain jnp (no Pallas kernel). Where the JAX function takes the
full logical arrays and shard_map cuts them, here each rank passes its own
chunk and gets its own output chunk.
"""
from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def ring_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: str = "model", causal: bool = True) -> torch.Tensor:
    """Attention over a sequence sharded on `axis`: rank i holds positions
    [i·s, (i+1)·s). q: (B, Hq, s, D); k, v: (B, Hkv, s, D), this rank's
    chunks. Returns this rank's (B, Hq, s, D) output in q's dtype."""
    n, my = mesh.size(axis), mesh.index(axis)
    b, hq, s_loc, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    pos = torch.arange(s_loc, device=q.device)
    q_pos = my * s_loc + pos

    m = torch.full((b, hq, s_loc, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, hq, s_loc, 1), device=q.device)
    o = torch.zeros((b, hq, s_loc, d), device=q.device)
    kv = torch.stack([k.float(), v.float()])     # one tensor a hop

    for t in range(n):
        src = (my - t) % n                       # whose chunk we hold
        kc = kv[0].repeat_interleave(group, dim=1)
        vc = kv[1].repeat_interleave(group, dim=1)
        sc = torch.einsum("bhqd,bhkd->bhqk", qf, kc) * scale
        if causal:
            k_pos = src * s_loc + pos
            mask = k_pos[None, :] <= q_pos[:, None]
            sc = torch.where(mask, sc, torch.full_like(sc, _NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vc)
        m = m_new
        del sc, p, kc, vc
        if t + 1 < n:
            kv = mesh.ring_shift(kv, axis)

    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    return (o / safe_l).to(q.dtype)
