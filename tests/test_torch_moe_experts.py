"""The grouped W8A16 expert products (kernels/moe_experts.py) on the CPU:
the plain version against the dequantized products it replaces and
against exact f32 arithmetic, the routed FFN's choice between the two
(models/moe._routed), `moe_forward` through the grouped route against
the JAX package's `moe_layer`, and the live slots: each expert's count of
claimed slots from the dispatch, the dead rows' +0 whatever the slots
held, the tile count and its attributes on `cached_generate`'s decode
span.

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



# ------------------------------------------------------------ live slots

# counts over the experts: none, one row, a tile less one, a tile, one past
# it, past two tiles, all 64, and more pairs than slots (clamped to C)
LIVE_COUNTS = (0, 1, 15, 16, 17, 33, 64, 90)


def _live_experts(seed: int = 6):
    e, c, d, f = len(LIVE_COUNTS), 64, 32, 48
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((e, c, d), generator=g).bfloat16()
    return x, _stack(g, e, d, f), _stack(g, e, d, f), _stack(g, e, f, d)


def _poison(x, counts):
    dead = torch.arange(x.shape[1]) >= counts[:, None]
    return x.masked_fill(dead[..., None], float("nan")), dead


def test_plain_counts_keep_live_rows_and_zero_dead_ones():
    x, w1, w3, w2 = _live_experts()
    counts = torch.tensor(LIVE_COUNTS)
    full = t_me.moe_experts_plain(x, w1, w3, w2)
    poisoned, dead = _poison(x, counts)
    got = t_me.moe_experts_plain(poisoned, w1, w3, w2, counts)
    assert torch.equal(got[~dead], full[~dead])
    assert not got[dead].any() and not torch.signbit(got[dead]).any()
    assert torch.equal(t_me.moe_experts(poisoned, w1, w3, w2, counts), got)
    with pytest.raises(ValueError, match="counts"):
        t_me.moe_experts(x, w1, w3, w2, counts.int())


def test_tile_counter_adds_live_and_all_tiles():
    x, w1, w3, w2 = _live_experts()
    counts = torch.tensor(LIVE_COUNTS)
    t_me.moe_experts(x, w1, w3, w2, counts)
    before = t_me.tile_counter("cpu").clone()
    t_me.moe_experts(x, w1, w3, w2, counts)
    t_me.moe_experts(x, w1, w3, w2)          # no counts: not counted
    # 0, 1, 1, 1, 2, 3, 4, 4 live m16 tiles of 4 an expert
    assert (t_me.tile_counter("cpu") - before).tolist() == [16, 32]


@pytest.mark.parametrize("pads", [False, True])
@pytest.mark.parametrize("cf", [4.0, 1.0, 0.5])
def test_dispatch_counts_are_routed_pairs_clamped_to_capacity(cf, pads):
    t, e, k = 24, 4, 2
    g = torch.Generator().manual_seed(11)
    indices = torch.stack([torch.randperm(e, generator=g)[:k]
                           for _ in range(t)])
    weights = torch.rand((t, k), generator=g)
    valid = torch.rand(t, generator=g) > 0.3 if pads else None
    cap = max(1, int(cf * t * k / e))
    slot, combine, counts = t_moe._dispatch_slots(indices, weights, e, cap,
                                                  valid, counts=True)
    routed = indices[valid] if pads else indices
    want = torch.bincount(routed.reshape(-1), minlength=e).clamp(max=cap)
    assert counts.dtype == torch.int64 and torch.equal(counts, want)
    # the claimed slots are rows 0..count-1 of each expert's C
    claimed = torch.zeros(e * cap + 1, dtype=torch.bool)
    claimed[slot.reshape(-1)] = True
    assert torch.equal(claimed[:-1].view(e, cap),
                       torch.arange(cap) < counts[:, None])
    # the slots and weights are the ones without counts
    slot0, combine0 = t_moe._dispatch_slots(indices, weights, e, cap, valid)
    assert torch.equal(slot0, slot) and torch.equal(combine0, combine)


@pytest.mark.parametrize("cf", [4.0, 1.25])
def test_routed_hands_the_grouped_products_its_counts(cf, monkeypatch):
    """`_routed` passes each expert's claimed slots (its valid pairs, pads
    out, clamped to C) to the grouped kernels, and its output is the
    zero-filled grid's."""
    params = _layer(5)
    params["gate"] = params["gate"].bfloat16()
    moe = t_config.MoEConfig(num_experts=4, num_experts_per_tok=2,
                             capacity_factor=cf)
    x = torch.randn((16, 32), generator=torch.Generator().manual_seed(8))
    x = x.bfloat16()
    valid = torch.arange(16) % 5 != 0
    calls = []
    real = t_moe.moe_experts
    monkeypatch.setattr(t_moe, "moe_experts",
                        lambda *a: calls.append(a) or real(*a))
    got = t_moe.moe_forward(x, params, moe, valid)
    (xs, *_, counts), = calls
    cap = xs.shape[1]
    _, indices, _ = t_moe.router(x, params["gate"], 2)
    want = torch.bincount(indices[valid].reshape(-1), minlength=4)
    assert torch.equal(counts, want.clamp(max=cap))
    monkeypatch.setattr(t_moe, "moe_experts", lambda x, *w: real(x, *w))
    zeroed = t_moe.moe_forward(x, params, moe, valid)
    assert torch.equal(got, zeroed)


def test_cached_generate_records_the_decode_tiles():
    """A bf16 MoE model with INT8 stacks (the grouped route, on the CPU its
    plain version): the decode span carries the m16 tiles of every MoE
    layer and step, E ceil(C / 16) each, the prefill's left out."""
    from physics_llm_inference_tpu_torch.models import quant as t_quant
    from physics_llm_inference_tpu_torch.models import transformer as t_tf
    from physics_llm_inference_tpu_torch.runtime import generate as t_gen
    from physics_llm_inference_tpu_torch.utils import tracing

    cfg = t_config.ModelConfig(
        vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_dim=96, max_seq_len=64,
        dtype="bfloat16", num_experts=4, num_experts_per_tok=2,
        expert_capacity_factor=4.0, fused_decode=False,
        attention_impl="dense")
    params = t_quant.quantize_params_int8(
        t_tf.init_params(torch.Generator().manual_seed(3), cfg))
    prompts = [[5, 9, 2], [7, 1, 8, 3, 4, 6]]
    steps = 3
    t_gen.cached_generate(params, cfg, prompts, steps, temperature=0.0,
                          kv_dtype=torch.int8)
    spans = tracing.RECORDER.snapshot().spans
    pre = [s for s in spans if s.name == "generate.prefill"][-1]
    dec = [s for s in spans if s.name == "generate.decode"][-1]
    # decode: 2 tokens a step, C = int(4.0 * 2 * 2 / 4) = 4, one tile each
    assert dec.attrs["expert_tiles"] == cfg.num_layers * steps * 4 * 1
    assert 0 < dec.attrs["expert_tiles_live"] <= dec.attrs["expert_tiles"]
    assert "expert_tiles" not in pre.attrs
