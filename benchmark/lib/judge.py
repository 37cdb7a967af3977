"""How `correct` is decided: the gap by which a served token's logit lies
below the reference's best at its position, over the sampled requests:
the widest gap, and the mean gap. A cell's file says which of the two it
compares and their limits.

The reference is the configuration's architecture module's `logits`
(lib/spec.py). A served token is greedy, so the reference's own choice
has gap 0, and a token the program chose at a near-tie has a small gap.
The control is the reference in the precision below the stated one (int4
weights), read on the same prompts and tokens: at each position, the gap
of the token the control puts first.
"""
from __future__ import annotations

import torch


def _positions(sample: dict) -> tuple[list, list]:
    prompt, toks = sample["prompt"], sample["tokens"]
    seq = list(prompt) + list(toks[:-1])
    first = len(prompt) - 1
    return seq, list(range(first, first + len(toks)))


def _stats(gap: torch.Tensor, prefix: str) -> dict:
    return {f"{prefix}_max": float(gap.max()),
            f"{prefix}_mean": float(gap.mean())}


def gaps(logits, w: dict, config: dict, samples: list,
         control: bool = False, witness: bool = False) -> dict:
    """Over every served token of `samples` (each a dict with `prompt` and
    `tokens`), against the reference `logits` (an architecture module's):
    the widest gap (`logit_gap_max`), the mean gap
    (`logit_gap_mean`) and the tokens' count; with `control` the control's
    `control_gap_max` and `control_gap_mean`. None where nothing was
    served."""
    if not samples:
        return {"logit_gap_max": None, "logit_gap_mean": None, "tokens": 0,
                "control_gap_max": None, "control_gap_mean": None}
    seqs, pos = zip(*(_positions(s) for s in samples))
    ref = logits(w, config, list(seqs), list(pos))
    ctrl = (logits(w, config, list(seqs), list(pos), int4=True)
            if control else [None] * len(ref))
    wit = (logits(w, config, list(seqs), list(pos), bf16=True)
           if witness else [None] * len(ref))
    served, chosen, seen = [], [], []
    for s, r, c, b in zip(samples, ref, ctrl, wit):
        toks = torch.as_tensor(s["tokens"], device=r.device).long()
        best = r.max(dim=-1).values
        served.append(best - r.gather(1, toks[:, None])[:, 0])
        if c is not None:
            pick = c.argmax(dim=-1, keepdim=True)
            chosen.append(best - r.gather(1, pick)[:, 0])
        if b is not None:
            pick = b.argmax(dim=-1, keepdim=True)
            seen.append(best - r.gather(1, pick)[:, 0])
    out = {**_stats(torch.cat(served), "logit_gap"),
           "tokens": sum(len(s["tokens"]) for s in samples)}
    if control:
        out.update(_stats(torch.cat(chosen), "control_gap"))
    if witness:
        out.update(_stats(torch.cat(seen), "witness_gap"))
    return out
