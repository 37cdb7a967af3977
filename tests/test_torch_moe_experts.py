"""The grouped W8A16 expert products (kernels/moe_experts.py) on the CPU:
the plain version against the dequantized products it replaces and
against exact f32 arithmetic, the routed FFN's choice between the two
(models/moe._routed), and `moe_forward` through the grouped route against
the JAX package's `moe_layer`.

Tolerances, from bf16's 8-bit significand (a rounding moves a value by at
most 2^-9 of itself): the grouped version rounds twice (the hidden grid,
the output), the dequantized path six times (each weight, h1, h3, silu,
their product, the output), so against the f32 truth the grouped version
is held to 2^-7 of the output's largest value and must lie no farther from
it than the dequantized path; the two paths agree within 2^-5 of the
largest value. Against the JAX package: `torch_parity.TOL["bfloat16"]`,
the MoE tests' bf16 tolerance, on the same routing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from physics_llm_inference_tpu.models import config as j_config
from physics_llm_inference_tpu.models import moe as j_moe
from physics_llm_inference_tpu.models import quant as j_quant
from physics_llm_inference_tpu_torch.kernels import moe_experts as t_me
from physics_llm_inference_tpu_torch.models import config as t_config
from physics_llm_inference_tpu_torch.models import moe as t_moe
from physics_llm_inference_tpu_torch.models.quant import QuantizedTensor
from torch_parity import assert_close, t2n

# (E, C, D, F, rows of each expert's C slots that hold a token): ragged
# loads, an expert with no rows, C below and at the kernels' 64
SHAPES = {
    "ragged": (4, 10, 64, 96, (10, 3, 0, 7)),
    "one-slot": (3, 1, 32, 48, (1, 0, 1)),
    "full": (2, 64, 32, 64, (64, 40)),
}


def _stack(g, e, k, n) -> QuantizedTensor:
    """An INT8 stack with per-(expert, channel) scales of a product of
    std ~fan_in**-0.5."""
    q = torch.randint(-127, 128, (e, k, n), dtype=torch.int8, generator=g)
    s = (torch.rand((e, 1, n), generator=g) + 0.5) / (73.3 * k ** 0.5)
    return QuantizedTensor(q, s)


def _experts(shape: str, seed: int = 0):
    e, c, d, f, rows = SHAPES[shape]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((e, c, d), generator=g).bfloat16()
    for i, n in enumerate(rows):
        x[i, n:] = 0          # slots nobody claimed stay 0
    return x, _stack(g, e, d, f), _stack(g, e, d, f), _stack(g, e, f, d)


def _dequantized(x, w1, w3, w2):
    """The products as `_routed` computed them before the grouped route:
    each stack dequantized into x's dtype, torch.bmm, silu(h1) * h3."""
    w1, w3, w2 = (w.dequantize(x.dtype) for w in (w1, w3, w2))
    return torch.bmm(F.silu(torch.bmm(x, w1)) * torch.bmm(x, w3), w2)


def _exact(x, w1, w3, w2):
    """The same function in f64 with no rounding between the products."""
    xd = x.double()
    h1 = torch.bmm(xd, w1.q.double()) * w1.s.double()
    h3 = torch.bmm(xd, w3.q.double()) * w3.s.double()
    return torch.bmm(F.silu(h1) * h3, w2.q.double()) * w2.s.double()


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_grouped_matches_dequantized_products(shape):
    x, w1, w3, w2 = _experts(shape)
    got = t_me.moe_experts(x, w1, w3, w2)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, t_me.moe_experts_plain(x, w1, w3, w2))
    old = _dequantized(x, w1, w3, w2).double()
    exact = _exact(x, w1, w3, w2)
    top = float(exact.abs().max())
    err_new = float((got.double() - exact).abs().max())
    err_old = float((old - exact).abs().max())
    assert err_new <= 2 ** -7 * top
    assert err_new <= err_old
    torch.testing.assert_close(got.double(), old, rtol=0, atol=2 ** -5 * top)
    # rows with no token give 0 in every expert
    _, _, _, _, rows = SHAPES[shape]
    for i, n in enumerate(rows):
        assert not got[i, n:].any()


def _layer(seed: int, d: int = 32, f: int = 64, e: int = 4):
    g = torch.Generator().manual_seed(seed)
    gate = (torch.randn((d, e), generator=g) * d ** -0.5)
    return {"gate": gate, "w1": _stack(g, e, d, f), "w3": _stack(g, e, d, f),
            "w2": _stack(g, e, f, d)}


def _old_routed(x, params, moe):
    """models/moe._routed's output before the grouped route (no `valid`)."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    e, k = moe.num_experts, moe.num_experts_per_tok
    capacity = max(1, int(moe.capacity_factor * t * k / e))
    weights, indices, _ = t_moe.router(xt, params["gate"], k)
    slot, combine = t_moe._dispatch_slots(indices, weights, e, capacity)
    grid = xt.new_zeros((e * capacity + 1, d))
    grid.index_copy_(0, slot.reshape(-1), xt.repeat_interleave(k, dim=0))
    expert_in = grid[:-1].view(e, capacity, d)
    out = _dequantized(expert_in, params["w1"], params["w3"], params["w2"]) \
        if isinstance(params["w1"], QuantizedTensor) else torch.bmm(
            F.silu(torch.bmm(expert_in, params["w1"]))
            * torch.bmm(expert_in, params["w3"]), params["w2"])
    picked = out.reshape(e * capacity, d)[
        slot.clamp(max=e * capacity - 1)].float()
    return (combine[..., None] * picked).sum(dim=1).to(x.dtype).reshape(
        x.shape)


# (tokens, capacity factor, activations, stacks): grouped exactly where
# the activations are bf16, the stacks INT8 and C <= 64
ROUTES = {
    "decode": (16, 4.0, torch.bfloat16, "int8", True),
    "decode-dropping": (24, 1.25, torch.bfloat16, "int8", True),
    "prefill": (160, 4.0, torch.bfloat16, "int8", False),
    "f32": (16, 4.0, torch.float32, "int8", False),
    "plain-stacks": (16, 4.0, torch.bfloat16, "plain", False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_takes_the_grouped_products_only_where_they_fit(case,
                                                              monkeypatch):
    t, cf, dtype, stacks, grouped = ROUTES[case]
    params = _layer(1)
    params["gate"] = params["gate"].to(dtype)
    if stacks == "plain":
        for n in ("w1", "w3", "w2"):
            params[n] = params[n].dequantize(dtype)
    moe = t_config.MoEConfig(num_experts=4, num_experts_per_tok=2,
                             capacity_factor=cf)
    assert (max(1, int(cf * t * 2 / 4)) <= t_me.MAX_SLOTS) == \
        (case not in ("prefill",))
    calls = []
    real = t_moe.moe_experts
    monkeypatch.setattr(t_moe, "moe_experts",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x = torch.randn((t, 32), generator=torch.Generator().manual_seed(2))
    x = x.to(dtype)
    got = t_moe.moe_forward(x, params, moe)
    assert len(calls) == int(grouped)
    if grouped:
        e, c = calls[0][:2]
        assert (e, c) == (4, max(1, int(cf * t * 2 / 4)))
        old = _old_routed(x, params, moe)
        top = float(old.float().abs().max())
        torch.testing.assert_close(got.float(), old.float(), rtol=0,
                                   atol=2 ** -5 * top)
    else:
        assert torch.equal(got, _old_routed(x, params, moe))


@pytest.mark.parametrize("seed", [3, 4])
def test_moe_forward_grouped_matches_jax_moe_layer(seed, monkeypatch):
    """A decode step's FFN (16 tokens, top-2 of 4 experts at capacity
    factor 4.0, C = 32) in bf16 over INT8 stacks: the port through the
    grouped route against the JAX package's moe_layer on the same int8
    values and scales, with the same routing."""
    params = _layer(seed)
    params["gate"] = params["gate"].bfloat16()
    kw = dict(num_experts=4, num_experts_per_tok=2, capacity_factor=4.0)
    jp = {"gate": jnp.asarray(params["gate"].float().numpy(), jnp.bfloat16)}
    for n in ("w1", "w3", "w2"):
        jp[n] = j_quant.QuantizedTensor(jnp.asarray(params[n].q.numpy()),
                                        jnp.asarray(params[n].s.numpy()))
    x = np.random.default_rng(seed).standard_normal((2, 8, 32))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    jout, jaux = j_moe.moe_layer(jx, jp, j_config.MoEConfig(**kw))
    calls = []
    real = t_moe.moe_experts
    monkeypatch.setattr(t_moe, "moe_experts",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    tout, taux = t_moe.moe_layer(tx, params, t_config.MoEConfig(**kw))
    np.testing.assert_array_equal(t2n(taux["indices"]),
                                  np.asarray(jaux["indices"]))
    assert taux["capacity"] == jaux["capacity"] == 32
    assert float(taux["dropped"]) == 0.0
    assert_close(t2n(tout.float()), np.asarray(jout.astype(jnp.float32)),
                 "bfloat16")
    assert calls == [(4, 32, 32)]

