"""Token sampling: greedy / temperature / top-k / top-p
(counterpart: physics_llm_inference_tpu/ops/sampling.py).

Draws come from a caller-owned `torch.Generator` where the JAX package takes
a PRNG key. The two generators give different numbers from the same seed,
so the filters (`_apply_top_k`, `_apply_top_p`) are what is held against
the reference, not the drawn ids.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_NEG_INF = -1e30


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration. temperature, top_k and top_p are
    runtime values; a per-request top_k rides as a (B,) tensor."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    max_tokens: int = 128
    stop_tokens: tuple[int, ...] = ()


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis; ties go to the first maximal index."""
    return torch.argmax(logits, dim=-1)


def _apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, _NEG_INF)


def _apply_top_k_dynamic(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-request top-k with k a (B,) tensor (k <= 0 keeps the whole row):
    one vocab sort serves every row's own k."""
    v = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    idx = (k[..., None].long() - 1).clamp(0, v - 1)
    kth = torch.gather(sorted_desc, -1, idx)
    keep = (k <= 0)[..., None] | (logits >= kth)
    return torch.where(keep, logits, torch.full_like(logits, _NEG_INF))


def _apply_top_p(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the descending sort whose
    probability mass reaches top_p (always at least one token)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) < top_p
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf")))
    thresh = thresh.amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < thresh, _NEG_INF)


def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 temperature=1.0, top_k=0, top_p=1.0) -> torch.Tensor:
    """Next-token ids from (..., V) logits.

    temperature <= 0 selects greedy per element, so a batch may mix greedy and
    sampled rows. An int top_k filters every row alike (0: off); a tensor
    gives each row its own k. top_p=None skips the nucleus sort. With
    temperature, a tensor top_k and top_p given as tensors on the logits'
    device nothing here reads a value on the host, so the call can be
    captured in a CUDA graph (a Python float would be copied from pageable
    memory, which capture refuses); the generator must then be registered
    with the graph (`CapturedStep`'s `generators`)."""
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=logits.device)
    greedy = greedy_sample(logits)
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    scaled = logits.float() / safe_t[..., None]
    if isinstance(top_k, (int, np.integer)):
        if top_k > 0:
            scaled = _apply_top_k(scaled, int(top_k))
    else:
        scaled = _apply_top_k_dynamic(
            scaled, torch.as_tensor(top_k, device=logits.device))
    if top_p is not None:
        top_p = torch.as_tensor(top_p, dtype=torch.float32,
                                device=logits.device)
        scaled = _apply_top_p(scaled, top_p[..., None])
    probs = torch.softmax(scaled, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    sampled = torch.multinomial(flat, 1, generator=generator)
    sampled = sampled.reshape(probs.shape[:-1])
    return torch.where(temperature > 0, sampled, greedy)
