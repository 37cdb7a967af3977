"""The port's MoE slice against the JAX package's: the routed layer
(models/moe.py), the planner (models/moe_inference.py), the MoE leaves of
init, INT8/INT4 quantization and conversion, `count_parameters`, and the
routed FFN through `forward` and `cached_generate`, on the same
numpy-seeded inputs.

Tolerances: routing integers (capacity, slots, drops) and the dispatch and
combine masks exactly; the router's f32 probs and weights within 1e-5
relative (XLA and torch round the gate product and the softmax apart by
ulps), its indices equal wherever the top-k margin exceeds that; the
layer's output on fixed routing within 1e-5 relative (the gather is exact
and the K = 2 combine sum is order-free); whole models within
`torch_parity.TOL["float32"]`; greedy tokens identical. End-to-end parity
runs at capacity factor 4.0 (no pair dropped, so an ulp cannot move a pair
past an expert's capacity), as the JAX package's own engine tests do."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.models import config as j_config
from physics_llm_inference_tpu.models import moe as j_moe
from physics_llm_inference_tpu.models import moe_inference as j_inf
from physics_llm_inference_tpu.models import quant as j_quant
from physics_llm_inference_tpu.models import transformer as j_tf
from physics_llm_inference_tpu.runtime import generate as j_gen
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models import config as t_config
from physics_llm_inference_tpu_torch.models import moe as t_moe
from physics_llm_inference_tpu_torch.models import moe_inference as t_inf
from physics_llm_inference_tpu_torch.models import quant as t_quant
from physics_llm_inference_tpu_torch.models import transformer as t_tf
from physics_llm_inference_tpu_torch.ops.ffn import swiglu
from physics_llm_inference_tpu_torch.runtime import generate as t_gen
from torch_parity import assert_close, t2n, to_numpy

# the layer-level config of tests/test_models.py::TestMoE
LAYER = dict(vocab_size=50, hidden_dim=32, num_layers=1, num_heads=2,
             num_kv_heads=2, intermediate_dim=64, dtype="float32")
# the model of tests/test_models.py::TestMoETransformer
MODEL = dict(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_dim=96, max_seq_len=64,
             dtype="float32", num_experts=4, num_experts_per_tok=2,
             expert_capacity_factor=4.0)
E, K = 4, 2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def layer_params():
    """One JAX expert layer and the same weights as torch tensors."""
    jp = j_moe.init_moe_params(jax.random.PRNGKey(2),
                               j_config.ModelConfig(**LAYER),
                               j_config.MoEConfig(num_experts=E,
                                                  num_experts_per_tok=K))
    return jp, {n: _t(w) for n, w in jp.items()}


def _x(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (*shape, LAYER["hidden_dim"])).astype(np.float32)


def _dense_masks(slot, combine, num_experts: int, capacity: int):
    """The JAX package's (T, E, C) dispatch and combine masks from the
    port's slots and combine weights."""
    t, k = slot.shape
    grid = torch.zeros((t, num_experts * capacity + 1))
    rows = torch.arange(t)[:, None].expand(t, k)
    dispatch = grid.index_put((rows, slot), torch.ones_like(combine))
    comb = grid.index_put((rows, slot), combine)
    shape = (t, num_experts, capacity)
    return dispatch[:, :-1].reshape(shape), comb[:, :-1].reshape(shape)


def _moe(cf: float):
    kw = dict(num_experts=E, num_experts_per_tok=K, capacity_factor=cf)
    return j_config.MoEConfig(**kw), t_config.MoEConfig(**kw)


def _valid(kind: str, t: int):
    """None, a left-padded batch's mask, or a scattered one."""
    if kind == "none":
        return None
    if kind == "left-pad":
        return np.arange(t) >= t // 3
    return np.random.default_rng(9).random(t) > 0.4


# ------------------------------------------------------------- configs

def test_configs_match_reference():
    assert dataclasses.asdict(t_config.MoEConfig()) == \
        dataclasses.asdict(j_config.MoEConfig())
    tm, jm = t_config.MIXTRAL_MOE_CONFIG, j_config.MIXTRAL_MOE_CONFIG
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    # param_count stays dense-only, as the reference's is
    assert tm.param_count() == jm.param_count()
    moe = t_config.ModelConfig(**MODEL)
    assert moe.param_count() == j_config.ModelConfig(**MODEL).param_count()


# -------------------------------------------------------------- router

def test_router_matches_reference(layer_params):
    jp, tp = layer_params
    x = _x(3, 40)
    jw, ji, jprobs = j_moe.router(jnp.asarray(x), jp["gate"], K)
    tw, ti, tprobs = t_moe.router(_t(x), tp["gate"], K)
    np.testing.assert_allclose(t2n(tprobs), np.asarray(jprobs), rtol=1e-5)
    np.testing.assert_allclose(t2n(tw), np.asarray(jw), rtol=1e-5)
    # the reference's renormalization and ranges (TestMoE)
    np.testing.assert_allclose(t2n(tw).sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(t2n(tprobs).sum(-1), 1.0, rtol=1e-5)
    assert tw.shape == (40, K) and ti.shape == (40, K)
    # indices equal wherever each of the top K+1 ranks is apart from the
    # next by more than the tolerance
    srt = -np.sort(-np.asarray(jprobs), axis=-1)
    clear = (srt[:, :K] - srt[:, 1:K + 1]).min(axis=-1) > 1e-5
    assert clear.mean() > 0.8
    np.testing.assert_array_equal(t2n(ti)[clear], np.asarray(ji)[clear])


TIES = {
    # the row of the issue: jax.lax.top_k gives [1, 2], torch.topk [1, 3]
    "three-way": ([0.1, 0.3, 0.3, 0.3, 0.0], 2, [1, 2]),
    "all-equal": ([0.5] * 8, 2, [0, 1]),
    "tie-at-k": ([0.0, 1.0, 1.0, 0.0, 1.0], 3, [1, 2, 4]),
    "below-k": ([0.2, 0.9, 0.2, 0.2], 2, [1, 0]),
}


@pytest.mark.parametrize("case", list(TIES))
def test_router_ties_go_to_lower_index(case):
    """Equal logits give equal probabilities; the top-k keeps the lower
    expert index first, as jax.lax.top_k does."""
    row, k, want = TIES[case]
    x = np.ones((1, 1), np.float32)
    gate = np.asarray([row], np.float32)         # x @ gate == row exactly
    _, ji, _ = j_moe.router(jnp.asarray(x), jnp.asarray(gate), k)
    _, ti, _ = t_moe.router(_t(x), _t(gate), k)
    assert np.asarray(ji)[0].tolist() == want
    assert t2n(ti)[0].tolist() == want


def test_router_bf16_ties_match_reference():
    """bf16 activations: the gate product is rounded before the f32
    softmax, so two equal gate columns tie on every row; both packages
    rank the lower of the two experts first."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    gate = rng.standard_normal((32, 8)).astype(np.float32)
    gate[:, 5] = gate[:, 2]
    jx = jnp.asarray(x, jnp.bfloat16)
    _, ji, _ = j_moe.router(jx, jnp.asarray(gate, jnp.bfloat16), 2)
    _, ti, _ = t_moe.router(_t(x).bfloat16(), _t(gate).bfloat16(), 2)
    ji, ti = np.asarray(ji), t2n(ti)
    np.testing.assert_array_equal(ti, ji)
    assert (ti[:, 0] == 2).any() and not (ti[:, 0] == 5).any()
    assert ((ti[:, 1] == 5) == (ti[:, 0] == 2)).all()


# ------------------------------------------------------------ dispatch

@pytest.mark.parametrize("valid", ["none", "left-pad", "scattered"])
@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_dispatch_matches_reference(layer_params, cf, valid):
    """On the JAX router's own indices and weights, the port's slots give
    the reference's (T, E, C) dispatch and combine masks exactly."""
    jp, _ = layer_params
    t = 48
    jw, ji, _ = j_moe.router(jnp.asarray(_x(5, t)), jp["gate"], K)
    cap = max(1, int(cf * t * K / E))
    v = _valid(valid, t)
    jd, jc = j_moe._dispatch_masks(ji, jw, E, cap,
                                   None if v is None else jnp.asarray(v))
    slot, comb = t_moe._dispatch_slots(_t(ji).long(), _t(jw), E, cap,
                                       None if v is None else _t(v))
    td, tc = _dense_masks(slot, comb, E, cap)
    np.testing.assert_array_equal(t2n(td), np.asarray(jd))
    np.testing.assert_array_equal(t2n(tc), np.asarray(jc))
    if cf == 0.5:
        assert (t2n(slot) == E * cap).any()     # this case drops pairs


@pytest.mark.parametrize("valid", ["none", "left-pad", "scattered"])
@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_moe_layer_matches_reference_on_fixed_routing(layer_params,
                                                      monkeypatch, cf,
                                                      valid):
    """Both layers on the JAX router's routing: the same capacity and
    drops, outputs within 1e-5 relative, pads' rows 0."""
    jp, tp = layer_params
    x = _x(6, 2, 24)
    jw, ji, jprobs = j_moe.router(jnp.asarray(x.reshape(48, -1)), jp["gate"],
                                  K)
    monkeypatch.setattr(j_moe, "router", lambda *a: (jw, ji, jprobs))
    monkeypatch.setattr(t_moe, "router", lambda *a, **kw: (
        _t(jw), _t(ji).long(), _t(jprobs)))
    jm, tm = _moe(cf)
    v = _valid(valid, 48)
    jv = None if v is None else jnp.asarray(v.reshape(2, 24))
    tv = None if v is None else _t(v.reshape(2, 24))
    jout, jaux = j_moe.moe_layer(jnp.asarray(x), jp, jm, valid=jv)
    tout, taux = t_moe.moe_layer(_t(x), tp, tm, valid=tv)
    assert tout.shape == (2, 24, LAYER["hidden_dim"])
    np.testing.assert_allclose(t2n(tout), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    assert taux["capacity"] == jaux["capacity"]
    assert float(taux["dropped"]) == float(jaux["dropped"])
    if v is not None:
        assert not t2n(tout).reshape(48, -1)[~v].any()


@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_moe_layer_matches_reference(layer_params, cf):
    """Router included, f32: the same routing (no near-tie on these
    inputs) and outputs within 1e-5 relative."""
    jp, tp = layer_params
    x = _x(7, 2, 8)
    jm, tm = _moe(cf)
    jout, jaux = j_moe.moe_layer(jnp.asarray(x), jp, jm)
    tout, taux = t_moe.moe_layer(_t(x), tp, tm)
    np.testing.assert_array_equal(t2n(taux["indices"]),
                                  np.asarray(jaux["indices"]))
    np.testing.assert_allclose(t2n(tout), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    assert float(taux["dropped"]) == float(jaux["dropped"])
    assert bool(torch.isfinite(tout).all()) and taux["capacity"] >= 1


@pytest.mark.parametrize("valid", ["none", "scattered"])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_forward_is_moe_layer_output(layer_params, cf, valid):
    """The model's FFN entry (no aux) gives moe_layer's output bit for
    bit, drops and pads included."""
    _, tp = layer_params
    x = _t(_x(13, 2, 24))
    _, tm = _moe(cf)
    v = _valid(valid, 48)
    tv = None if v is None else _t(v.reshape(2, 24))
    out, _ = t_moe.moe_layer(x, tp, tm, valid=tv)
    assert torch.equal(t_moe.moe_forward(x, tp, tm, valid=tv), out)


def test_moe_layer_matches_per_expert_loop(layer_params):
    """Capacity-grid dispatch equals an explicit loop over each token's
    experts when nothing is dropped (TestMoE, on the port alone)."""
    _, tp = layer_params
    x = _t(_x(5, 6))
    _, tm = _moe(8.0)
    out, _ = t_moe.moe_layer(x, tp, tm)
    w, idx, _ = t_moe.router(x, tp["gate"], K)
    want = torch.zeros_like(x)
    for t in range(6):
        for j in range(K):
            e = int(idx[t, j])
            want[t] += w[t, j] * swiglu(x[t:t + 1], tp["w1"][e], tp["w3"][e],
                                        tp["w2"][e])[0]
    torch.testing.assert_close(out, want, atol=1e-4, rtol=0)


def test_pads_cannot_steal_expert_capacity(layer_params):
    """tests/test_moe_serving.py::TestPadRouting on the port, and its padded
    output against JAX's: masked left pads claim no capacity, so the real
    tokens route as they would alone at the same capacity; unmasked, the
    pads take the capacity first."""
    jp, tp = layer_params
    real = _x(11, 6)
    pad = _x(12, 1)
    padded = np.concatenate([np.repeat(pad, 10, axis=0), real])
    valid = np.arange(16) >= 10
    jm, tm = _moe(1.25)
    out_padded, _ = t_moe.moe_layer(_t(padded), tp, tm, valid=_t(valid))
    j_padded, _ = j_moe.moe_layer(jnp.asarray(padded), jp, jm,
                                  valid=jnp.asarray(valid))
    np.testing.assert_allclose(t2n(out_padded), np.asarray(j_padded),
                               rtol=1e-5, atol=1e-6)
    _, tm16 = _moe(1.25 * 16 / 6)
    out_solo, _ = t_moe.moe_layer(_t(real), tp, tm16)
    torch.testing.assert_close(out_padded[10:], out_solo, rtol=1e-5,
                               atol=1e-5)
    out_nomask, _ = t_moe.moe_layer(_t(padded), tp, tm)
    assert not torch.allclose(out_nomask[10:], out_solo, rtol=1e-3,
                              atol=1e-3)


PRESSURE = {
    # 32 identical tokens: capacity int(1.25 * 32 * 2 / 4) = 20 on the
    # same two experts -> 24 dropped pairs
    "crowded": (1.25, True, 24),
    "ample": (4.0, False, 0),
    "tiny-capacity": (0.1, False, None),
}


@pytest.mark.parametrize("case", list(PRESSURE))
def test_capacity_pressure_matches_reference(layer_params, case):
    jp, tp = layer_params
    cf, same, want = PRESSURE[case]
    x = np.repeat(_x(1, 1), 32, axis=0) if same else _x(1, 32)
    jm, tm = _moe(cf)
    jout, jaux = j_moe.moe_layer(jnp.asarray(x), jp, jm)
    tout, taux = t_moe.moe_layer(_t(x), tp, tm)
    assert float(taux["dropped"]) == float(jaux["dropped"])
    if want is not None:
        assert float(taux["dropped"]) == want
    assert bool(torch.isfinite(tout).all()) and tout.shape == (32, 32)
    np.testing.assert_allclose(t2n(tout), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)


def test_load_balance_loss_matches_reference():
    t = 64
    probs = np.full((t, E), 1 / E, np.float32)
    idx = np.tile(np.arange(E), t // E * 2).reshape(t, 2)
    # a uniform router: k * 1.0 (ref ch09/moe_layer.py:86-98)
    assert float(t_moe.expert_load_balance_loss(_t(probs), _t(idx), E)) == \
        pytest.approx(2.0, rel=1e-3)
    rng = np.random.default_rng(8)
    probs = rng.dirichlet(np.ones(E), t).astype(np.float32)
    idx = rng.integers(0, E, (t, K))
    want = j_moe.expert_load_balance_loss(jnp.asarray(probs),
                                          jnp.asarray(idx), E)
    got = t_moe.expert_load_balance_loss(_t(probs), _t(idx), E)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# --------------------------------------------------------------- planner

def _cache_ops(mod):
    """tests/test_moe_inference.py's cache sequences, with what they saw."""
    c = mod.ExpertCache(capacity=2)
    c.put(0, "e0")
    c.put(1, "e1")
    c.get_expert(0)
    c.put(2, "e2")
    seen = [0 in c, 1 in c, 2 in c, c.evictions, c.stats()]
    c = mod.ExpertCache(capacity=4)
    loads = []
    c.get_expert(3, load_fn=lambda e: loads.append(e) or f"w{e}")
    seen += [c.get_expert(3), loads, c.stats()]
    c.put(3, "w3b")
    seen += [c.get_expert(3), c.stats()]
    return seen


def _planner_ops(mod):
    cache = mod.ExpertCache(capacity=4)
    cache.put(1, "w1")
    planner = mod.MoEInferencePlanner(num_experts=4, cache=cache)
    seen = [planner.plan_expert_execution([1, 2, 1, 3]),
            planner.load_balance_metrics()]
    planner.record_routing([0, 0, 1, 2, 3])
    seen += [planner.load_balance_metrics(), list(planner.expert_counts)]
    return seen


@pytest.mark.parametrize("ops", [_cache_ops, _planner_ops])
def test_planner_copy_matches_original(ops):
    got, want = ops(t_inf), ops(j_inf)
    assert got == want
    if ops is _cache_ops:
        assert got[:4] == [True, False, True, 1]
        assert got[4]["hits"] == 1 and got[5:7] == ["w3", [3]]
        assert got[7]["hit_rate"] == 0.5
    else:
        assert got[0] == {"cached": [1], "need_load": [2, 3], "num_unique": 3}
        assert got[2]["total"] == 5 and got[2]["max"] == 2 \
            and got[2]["min"] == 1


# ------------------------------------------------ init, quantize, convert

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layouts_match_reference(dtype):
    kw = dict(MODEL, dtype=dtype)
    jtree = j_tf.init_params(jax.random.PRNGKey(0),
                             j_config.ModelConfig(**kw))
    ttree = t_tf.init_params(torch.Generator().manual_seed(0),
                             t_config.ModelConfig(**kw))
    assert set(ttree["blocks"]) == set(jtree["blocks"])
    assert "w_gate_up" not in ttree["blocks"]
    for name, w in jtree["blocks"].items():
        t = ttree["blocks"][name]
        assert tuple(t.shape) == w.shape and str(t.dtype)[6:] == str(w.dtype)
    jl = j_moe.init_moe_params(jax.random.PRNGKey(0),
                               j_config.ModelConfig(**LAYER), _moe(1.25)[0])
    tl = t_moe.init_moe_params(torch.Generator().manual_seed(0),
                               t_config.ModelConfig(**LAYER), _moe(1.25)[1])
    assert {n: tuple(w.shape) for n, w in tl.items()} == \
        {n: w.shape for n, w in jl.items()}


@pytest.fixture(scope="module")
def moe_tree():
    """A JAX MoE tree in bf16 (the card's dtype) as numpy."""
    cfg = j_config.ModelConfig(**dict(MODEL, dtype="bfloat16"))
    return to_numpy(j_tf.init_params(jax.random.PRNGKey(3), cfg))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_trees_bit_equal_to_reference(moe_tree, bits):
    """One JAX tree quantized by each package: every leaf bit-equal, the
    expert stacks INT8 with (L, E, 1, N) scales in both formats (INT4 keeps
    them INT8, as the reference does)."""
    jq, tq = ((j_quant.quantize_params_int8, t_quant.quantize_params_int8)
              if bits == 8 else
              (j_quant.quantize_params_int4, t_quant.quantize_params_int4))
    want = params_from_jax(to_numpy(jq(jax.tree_util.tree_map(
        jnp.asarray, moe_tree))), device="cpu")
    got = tq(params_from_jax(moe_tree, device="cpu"))
    L, d, f = MODEL["num_layers"], MODEL["hidden_dim"], \
        MODEL["intermediate_dim"]
    for name, w in want["blocks"].items():
        g = got["blocks"][name]
        assert type(g) is type(w), name
        for a, b in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    for name, kn in (("moe_w1", (d, f)), ("moe_w3", (d, f)),
                     ("moe_w2", (f, d))):
        w = got["blocks"][name]
        assert isinstance(w, t_quant.QuantizedTensor), name
        assert tuple(w.q.shape) == (L, E, *kn) and w.q.dtype == torch.int8
        assert tuple(w.s.shape) == (L, E, 1, kn[1])
    assert not isinstance(got["blocks"]["moe_gate"], tuple)
    torch.testing.assert_close(got["lm_head"].q, want["lm_head"].q,
                               rtol=0, atol=0)


def test_convert_takes_expert_stacks_and_refuses_malformed(moe_tree):
    """`_quant_leaf` carries (L, E, K, N) int8 stacks with (L, E, 1, N)
    scales, and a 4-D stack whose scales miss the expert axis raises."""
    from physics_llm_inference_tpu_torch.convert import _quant_leaf

    leaf = j_quant.quantize_params_int8(jax.tree_util.tree_map(
        jnp.asarray, moe_tree))["blocks"]["moe_w2"]
    got = _quant_leaf(to_numpy(leaf), "cpu")
    assert tuple(got.q.shape) == leaf.q.shape and \
        tuple(got.s.shape) == leaf.s.shape
    bad = j_quant.QuantizedTensor(np.asarray(leaf.q),
                                  np.asarray(leaf.s)[:, :1])
    with pytest.raises(ValueError, match="int8"):
        _quant_leaf(bad, "cpu")


@pytest.mark.parametrize("quantized", [False, True])
def test_count_parameters_matches_reference(moe_tree, quantized):
    jtree = jax.tree_util.tree_map(jnp.asarray, moe_tree)
    if quantized:
        jtree = j_quant.quantize_params_int8(jtree)
    got = t_tf.count_parameters(params_from_jax(to_numpy(jtree),
                                                device="cpu"))
    assert got == {k: int(v) for k, v in
                   j_tf.count_parameters(jtree).items()}


# ------------------------------------------------------ the MoE model

@pytest.fixture(scope="module")
def moe_model():
    jcfg = j_config.ModelConfig(**MODEL)
    jparams = j_tf.init_params(jax.random.PRNGKey(1), jcfg)
    return (jcfg, t_config.ModelConfig(**MODEL), jparams,
            params_from_jax(to_numpy(jparams), device="cpu"))


@pytest.mark.parametrize("quantized", [False, True])
def test_moe_forward_matches_reference(moe_model, quantized):
    """Logits of the MoE model (TestMoETransformer's) against JAX's, f32
    and INT8 weights; and causality on the port: the last token moves no
    earlier position's logits."""
    jcfg, tcfg, jparams, tparams = moe_model
    if quantized:
        jparams = j_quant.quantize_params_int8(jparams)
        tparams = t_quant.quantize_params_int8(tparams)
    ids = np.random.default_rng(2).integers(0, 100, (2, 10))
    jl, _ = j_tf.forward(jparams, jnp.asarray(ids), jcfg)
    tl, _ = t_tf.forward(tparams, _t(ids), tcfg)
    assert tl.shape == (2, 10, 100)
    assert_close(t2n(tl), jl, "float32")
    ids2 = ids.copy()
    ids2[:, -1] = 99
    tl2, _ = t_tf.forward(tparams, _t(ids2), tcfg)
    torch.testing.assert_close(tl2[:, :-1], tl[:, :-1], atol=1e-4, rtol=0)


def test_int8_experts_close_to_fp(moe_model):
    """tests/test_moe_inference.py::TestQuantizedMoE on the port: the INT8
    expert stacks are dequantized in the routed layer."""
    _, tcfg, _, tparams = moe_model
    ids = (torch.arange(12).reshape(2, 6) * 5 + 1) % 100
    ref, _ = t_tf.forward(tparams, ids, tcfg)
    out, _ = t_tf.forward(t_quant.quantize_params_int8(tparams), ids, tcfg)
    assert float((out - ref).norm() / ref.norm()) < 0.05


@pytest.mark.parametrize("cf", [4.0, 1.25])
def test_moe_cached_generate_tokens_identical(moe_model, cf):
    """MoE `cached_generate` (INT8 weights and KV, per-op decode, dense
    attention pinned on both sides): ragged prompts, so left padding is
    taken out of routing by `valid` in prefill and decode; greedy tokens,
    prompt and generated lengths identical to the JAX package's."""
    jcfg, tcfg, jparams, tparams = moe_model
    kw = dict(expert_capacity_factor=cf, fused_decode=False,
              attention_impl="dense")
    jcfg, tcfg = (dataclasses.replace(jcfg, **kw),
                  dataclasses.replace(tcfg, **kw))
    jparams = j_quant.quantize_params_int8(jparams)
    tparams = t_quant.quantize_params_int8(tparams)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 100, n)) for n in (5, 11, 3, 16)]
    jout = j_gen.cached_generate(jparams, jcfg, prompts, 8, temperature=0.0,
                                 kv_dtype=jnp.int8)
    tout = t_gen.cached_generate(tparams, tcfg, prompts, 8, temperature=0.0,
                                 kv_dtype=torch.int8)
    np.testing.assert_array_equal(tout.tokens, jout.tokens)
    np.testing.assert_array_equal(tout.prompt_lens, jout.prompt_lens)
    np.testing.assert_array_equal(tout.gen_lens, jout.gen_lens)
