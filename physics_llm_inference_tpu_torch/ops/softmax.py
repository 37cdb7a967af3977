"""Online softmax, the recurrence flash attention is built on (counterpart:
physics_llm_inference_tpu/ops/softmax.py).

A Python loop over chunks of the last axis, where the JAX package scans
them: the running max m and normalizer d, with d (and the output
accumulator o) rescaled by exp(m_old - m_new) when a new max appears. The
executable spec of the flash kernel's tile loop (kernels/flash_attention.py,
csrc/flash_attention.cu), not a kernel.
"""
from __future__ import annotations

import torch


def _chunks(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """x (..., N) padded with -inf to a multiple of `chunk`, as
    (num_chunks, ..., chunk)."""
    pad = (-x.shape[-1]) % chunk
    xp = torch.nn.functional.pad(x, (0, pad), value=float("-inf"))
    return xp.reshape(*x.shape[:-1], -1, chunk).movedim(-2, 0)


def online_softmax(x: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Softmax over the last axis via the streaming (m, d) recurrence."""
    m = torch.full(x.shape[:-1], float("-inf"), dtype=x.dtype,
                   device=x.device)
    d = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for c in _chunks(x, chunk):
        m_new = torch.maximum(m, c.amax(dim=-1))
        d = d * torch.exp(m - m_new) + torch.exp(c - m_new[..., None]).sum(-1)
        m = m_new
    return torch.exp(x - m[..., None]) / d[..., None]


def online_softmax_with_output(scores: torch.Tensor, v: torch.Tensor,
                               chunk: int = 128) -> torch.Tensor:
    """Fused softmax(scores) @ v without materializing the weights.

    scores: (..., N), v: (N, D); also keeps the output accumulator o,
    rescaled on every new max: the math the flash kernel runs a K/V tile."""
    n = scores.shape[-1]
    pad = (-n) % chunk
    v_chunks = torch.nn.functional.pad(v, (0, 0, 0, pad)).reshape(
        -1, chunk, v.shape[-1])
    lead = scores.shape[:-1]
    m = torch.full(lead, float("-inf"), dtype=scores.dtype,
                   device=scores.device)
    d = torch.zeros(lead, dtype=scores.dtype, device=scores.device)
    o = torch.zeros((*lead, v.shape[-1]), dtype=scores.dtype,
                    device=scores.device)
    for s, vc in zip(_chunks(scores, chunk), v_chunks):
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        d = d * alpha + p.sum(-1)
        o = o * alpha[..., None] + p @ vc
        m = m_new
    return o / d[..., None]
