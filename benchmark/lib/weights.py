"""Weights made from the seed on the device, for any architecture: one
`torch.Generator` on the device, drawn in a few large calls. An
architecture module makes its tensors with these, in an order of its own,
and the same seed gives the same tensors."""
from __future__ import annotations

import torch

# a uniform int8 code in [-127, 127] has this standard deviation
INT8_STD = 73.9


def generator(seed: int, device) -> torch.Generator:
    """The generator of `seed` (any whole number) on `device`."""
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def uniform(g: torch.Generator, shape, lo: float, hi: float,
            dtype=torch.float32) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device=g.device)
    return t.uniform_(lo, hi, generator=g)


def int8_matrix(g: torch.Generator, lead: tuple, k: int, n: int):
    """Int8 codes (*lead, k, n), uniform in [-127, 127], and f32 scales
    (*lead, 1, n), one an output channel: the product's std is
    k**-0.5 times a factor in [0.75, 1.25] (the served W8A16 format)."""
    q = torch.randint(-127, 128, (*lead, k, n), dtype=torch.int8,
                      generator=g, device=g.device)
    s = uniform(g, (*lead, 1, n), 0.75, 1.25).mul_(k ** -0.5 / INT8_STD)
    return q, s
