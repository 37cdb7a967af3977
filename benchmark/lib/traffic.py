"""Traffic from a mix file and a seed.

Every seed gives the same set of sizes and gaps in another order: lengths
and inter-arrival gaps are the distribution's quantiles at (i + 0.5) / n,
shuffled by the seed, so the work of a run does not move with the seed
(only the order, the token ids and which requests meet which prefix
content). Token ids are uniform in [1, vocab) from the seed.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of one seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 63), *stream])


def quantiles(dist: dict, n: int) -> np.ndarray:
    """n quantiles at (i + 0.5) / n of `dist` (uniform {min..max},
    lognormal with median and sigma clipped to [min, max], or exponential
    with mean), ascending."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "uniform":
        lo, hi = dist["min"], dist["max"]
        return np.floor(lo + u * (hi - lo + 1)).astype(np.int64)
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        vals = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
        return np.clip(np.round(vals), dist["min"], dist["max"]).astype(
            np.int64)
    if kind == "exponential":
        return -np.log1p(-u) * dist["mean"]
    raise ValueError(f"unknown distribution {kind!r}")


def offline_batch(mix: dict, vocab: int, seed: int, index: int) -> list:
    """Batch `index` of an offline mix: `batch` prompts whose lengths are
    the quantiles of `prompt`, in the seed's order."""
    r = rng(seed, 1, index)
    lens = r.permutation(quantiles(mix["prompt"], mix["batch"]))
    return [r.integers(1, vocab, int(n)).tolist() for n in lens]


def open_loop(mix: dict, vocab: int, seed: int, seconds: float,
              stream: int = 3) -> list:
    """The requests of an open-loop window of `seconds`: round(rate x
    seconds) requests, each {due (s from the window's start), prompt,
    max_tokens, shared (prefix index or None)}. Prompt and output lengths
    are paired in a fixed order (the same for every seed); every
    `shared.every`-th of them in length order begins with one of
    `shared.prefixes` prefixes of `shared.prefix_len` tokens, its own tail
    cut so the prompt stays within `shared.max_prompt`. The seed orders the
    requests and the gaps and draws the token ids (from `stream`)."""
    n = max(1, round(mix["rate_rps"] * seconds))
    prompts = quantiles(mix["prompt"], n)
    outputs = rng(0, 2).permutation(quantiles(mix["output"], n))
    sh = mix.get("shared")
    r = rng(seed, stream)
    prefixes = ([r.integers(1, vocab, sh["prefix_len"]).tolist()
                 for _ in range(sh["prefixes"])] if sh else [])
    records = []
    for j in range(n):
        shared = None
        if sh and j % sh["every"] == 0:
            shared = (j // sh["every"]) % sh["prefixes"]
        records.append((int(prompts[j]), int(outputs[j]), shared))
    order = r.permutation(n)
    gaps = r.permutation(quantiles({"dist": "exponential",
                                    "mean": 1.0 / mix["rate_rps"]}, n))
    due = np.cumsum(gaps)
    due = due * (seconds * (1 - 0.5 / n) / due[-1])
    out = []
    for i, j in enumerate(order):
        plen, olen, shared = records[j]
        if shared is None:
            prompt = r.integers(1, vocab, plen).tolist()
        else:
            tail = min(plen, sh["max_prompt"] - sh["prefix_len"])
            prompt = prefixes[shared] + r.integers(1, vocab, tail).tolist()
        out.append({"due": float(due[i]), "prompt": prompt,
                    "max_tokens": olen, "shared": shared})
    return out
