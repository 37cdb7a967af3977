"""The port's parallel layer (physics_llm_inference_tpu_torch/parallel)
against the JAX package's on the same numpy inputs.

The port side runs in four spawned gloo processes (tests/torch_dist_workers
.py, which imports no jax): the mesh and its collectives, the TP forward
over model 4, a prefill and a decode step over data 2 x model 2 against
JAX's shard_map (fp32: logits within 1e-4, greedy tokens identical), the
explicit TP MLP, moe_layer_ep at capacity factors 8.0 and 1.25 (fp32 and
INT8 stacks), and ring attention, causal and not, within 1e-5 of the
whole-sequence attention JAX's own ring test holds its ring to. The JAX
side runs on the same mesh shapes of the virtual 8-device CPU mesh, while
the ranks run. One spawned world serves every test of the file.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_workers as workers
from physics_llm_inference_tpu.models import (ModelConfig, MoEConfig,
                                              init_params)
from physics_llm_inference_tpu.models.moe import init_moe_params
from physics_llm_inference_tpu.models.quant import _quantize_stacked
from physics_llm_inference_tpu.models.transformer import KVSlice, forward
from physics_llm_inference_tpu.ops import causal_attention, naive_attention
from physics_llm_inference_tpu.parallel import (make_mesh, tp_local_config,
                                                tp_mlp_shardmap,
                                                tp_prepare_params)
from physics_llm_inference_tpu.parallel import tp as jtp
from physics_llm_inference_tpu.parallel.ep import moe_layer_ep
from physics_llm_inference_tpu.specs import ici
from physics_llm_inference_tpu_torch import parallel as tpar
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models.config import \
    ModelConfig as TModelConfig
from physics_llm_inference_tpu_torch.models.config import \
    MoEConfig as TMoEConfig
from physics_llm_inference_tpu_torch.models.quant import (QuantizedTensor,
                                                          QuantizedTensor4)
from physics_llm_inference_tpu_torch.specs import nvlink
from torch_parity import to_numpy

CFG = dict(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=8,
           num_kv_heads=4, intermediate_dim=128, max_seq_len=128,
           dtype="float32")
MOE_CFG = dict(vocab_size=50, hidden_dim=32, num_layers=1, num_heads=2,
               num_kv_heads=2, intermediate_dim=64, dtype="float32")
TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_decode(params, cfg, ids):
    """Prefill then one greedy decode step under JAX's shard_map over
    data 2 x model 2: (logits of each, the K cache after the prefill)."""
    mesh = make_mesh(data=2, model=2)
    sharded = tp_prepare_params(params, cfg, mesh)
    local = tp_local_config(cfg, 2)
    specs = jtp.tp_param_spec_tree(sharded)
    kvp = jtp.tp_kv_spec(False)

    def fn(p, ids, k, v, start):
        logits, kvs = forward(p, ids, local, kv=KVSlice(k, v, start),
                              last_only=True)
        return logits, kvs.k, kvs.v

    step = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(specs, P("data"), kvp, kvp, P()),
        out_specs=(P("data"), kvp, kvp), check_vma=False))
    shape = (cfg.num_layers, ids.shape[0], 16, cfg.num_kv_heads,
             cfg.head_dim)
    k = v = jnp.zeros(shape, jnp.float32)
    l1, k1, v1 = step(sharded, jnp.asarray(ids), k, v, jnp.int32(0))
    tok = jnp.argmax(l1[:, -1], -1)[:, None].astype(jnp.int32)
    l2, _, _ = step(sharded, tok, k1, v1, jnp.int32(ids.shape[1]))
    return np.asarray(l1), np.asarray(l2), np.asarray(k1)


def _jax_forward(params, cfg, ids):
    mesh = make_mesh(data=1, model=4)
    sharded = tp_prepare_params(params, cfg, mesh)
    local = tp_local_config(cfg, 4, data_axis=None)
    specs = jtp.tp_param_spec_tree(sharded)
    fn = jax.jit(jax.shard_map(lambda p, i: forward(p, i, local)[0],
                               mesh=mesh, in_specs=(specs, P()),
                               out_specs=P(), check_vma=False))
    return np.asarray(fn(sharded, jnp.asarray(ids)))


def _jax_attention(ring):
    """The references JAX's own ring-attention test holds its ring to:
    causal and unmasked attention over the whole sequence, K/V repeated
    over each query group."""
    q, k, v = map(jnp.asarray, ring)
    g = q.shape[1] // k.shape[1]
    k, v = jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1)
    return {True: np.asarray(causal_attention(q, k, v)),
            False: np.asarray(naive_attention(q, k, v))}


def _moe_params_port(p):
    def leaf(w):
        if hasattr(w, "q"):
            return QuantizedTensor(torch.from_numpy(np.array(w.q)),
                                   torch.from_numpy(np.array(w.s)))
        return torch.from_numpy(np.array(w))
    return {k: leaf(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = ModelConfig(**CFG)
    params = init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    ids = {"forward": np.array([[10, 20, 30, 40, 50, 60]], np.int32),
           "decode": (np.arange(8).reshape(2, 4) % 50).astype(np.int32)}
    mlp = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in
           (((4, 32), 1.0), ((32, 64), 0.1), ((32, 64), 0.1),
            ((64, 32), 0.1))]
    mcfg = ModelConfig(**MOE_CFG)
    moe_x = rng.standard_normal((16, 32)).astype(np.float32)
    moe_jax, moe_port = {}, {}
    for name, cf, int8 in (("cf8", 8.0, False), ("cf1.25", 1.25, False),
                           ("int8_cf1.25", 1.25, True)):
        moe = MoEConfig(num_experts=8, num_experts_per_tok=2,
                        capacity_factor=cf)
        mp = init_moe_params(jax.random.PRNGKey(2), mcfg, moe)
        if int8:
            mp = {k: (v if k == "gate" else _quantize_stacked(v))
                  for k, v in mp.items()}
        moe_jax[name] = (mp, moe)
        moe_port[name] = (moe_x, _moe_params_port(mp),
                          TMoEConfig(**dataclasses.asdict(moe)))
    bad_moe = TMoEConfig(num_experts=6)
    bad_p = _moe_params_port(init_moe_params(
        jax.random.PRNGKey(6), mcfg, MoEConfig(num_experts=6)))
    ok_p = moe_port["cf8"][1]
    moe_bad = [(np.zeros((8, 32), np.float32), bad_p, bad_moe),
               (np.zeros((10, 32), np.float32), ok_p, moe_port["cf8"][2])]
    ring = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 4, 64, 32), (2, 2, 64, 32), (2, 2, 64, 32))]

    world = workers.World(
        "parallel_layer", 4, tmp_path_factory.mktemp("par"),
        params_from_jax(to_numpy(params), device="cpu"), TModelConfig(**CFG),
        ids, mlp, moe_port, moe_bad, ring)
    ref = {"forward": _jax_forward(params, cfg, ids["forward"]),
           "decode": _jax_decode(params, cfg, ids["decode"]),
           "mlp": np.asarray(tp_mlp_shardmap(make_mesh(data=1, model=4),
                                             *map(jnp.asarray, mlp))),
           "ep": {name: np.asarray(moe_layer_ep(
               make_mesh(data=1, expert=4, model=1), jnp.asarray(moe_x), mp,
               moe)) for name, (mp, moe) in moe_jax.items()},
           "ring": _jax_attention(ring)}
    return ref, world.results()


def test_make_mesh_shapes_and_refusals(runs):
    _, got = runs
    for r, out in enumerate(got):
        dm, dem, m4, transport = out["coords"]
        assert dm == {"data": r // 2, "model": r % 2}
        # ('data', 'expert', 'model'), model innermost
        assert dem == {"data": 0, "expert": r // 2, "model": r % 2}
        assert m4 == {"data": 0, "model": r}
        assert transport == "gloo on cpu"
        world_err, nccl_err = out["refusals"]
        assert world_err and "needs 3 ranks" in world_err
        assert nccl_err and "one GPU per rank" in nccl_err


def test_axis_groups_wait_as_the_world_does(runs):
    """make_mesh takes no timeout: every axis group gets the world's (torch
    would give a new group its own default, 30 minutes on gloo)."""
    _, got = runs
    for out in got:
        assert out["timeouts"] == [float(workers.PG_TIMEOUT_S)]


def test_make_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        tpar.make_mesh(model=2, device="cpu")


def test_collectives(runs):
    _, got = runs
    xs = [np.arange(8, dtype=np.float32).reshape(4, 2) + 100 * i
          for i in range(4)]
    for i, out in enumerate(got):
        c = out["collectives"]
        np.testing.assert_array_equal(c["all_reduce"], sum(xs))
        np.testing.assert_array_equal(c["all_gather"],
                                      np.concatenate(xs, axis=1))
        # row j of every rank's x goes to rank j, by source on dim 1
        np.testing.assert_array_equal(
            c["all_to_all"], np.concatenate([x[i:i + 1] for x in xs], 1))
        np.testing.assert_array_equal(c["ring_shift"], xs[(i - 1) % 4])
        np.testing.assert_array_equal(c["broadcast"], xs[2])


def test_tp_forward_matches_jax_shard_map(runs):
    ref, got = runs
    for out in got:
        np.testing.assert_allclose(out["forward"], ref["forward"], **TOL)
        np.testing.assert_array_equal(out["forward"].argmax(-1),
                                      ref["forward"].argmax(-1))


def test_tp_cached_decode_matches_jax_shard_map(runs):
    ref, got = runs
    l1, l2, k1 = ref["decode"]
    hkv = CFG["num_kv_heads"] // 2
    for r, out in enumerate(got):
        d, m = r // 2, r % 2
        g1, g2, gk = out["decode"]
        np.testing.assert_allclose(g1, l1[d:d + 1], **TOL)
        np.testing.assert_allclose(g2, l2[d:d + 1], **TOL)
        np.testing.assert_array_equal(g2.argmax(-1), l2[d:d + 1].argmax(-1))
        np.testing.assert_allclose(
            gk, k1[:, d:d + 1, :, m * hkv:(m + 1) * hkv], **TOL)


def test_tp_mlp_matches_jax(runs):
    ref, got = runs
    for out in got:
        np.testing.assert_allclose(out["mlp"], ref["mlp"], atol=1e-5)


@pytest.mark.parametrize("case", ["cf8", "cf1.25", "int8_cf1.25"])
def test_moe_layer_ep_matches_jax(runs, case):
    ref, got = runs
    for out in got:
        np.testing.assert_allclose(out["ep"][case], ref["ep"][case],
                                   atol=1e-5)


def test_moe_layer_ep_refusals(runs):
    _, got = runs
    for out in got:
        experts, tokens = out["ep_refusals"]
        assert experts and "num_experts 6" in experts
        assert tokens and "10 tokens" in tokens


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(runs, causal):
    ref, got = runs
    for i, out in enumerate(got):
        want = ref["ring"][causal][:, :, i * 16:(i + 1) * 16]
        np.testing.assert_allclose(out["ring"][causal], want, atol=1e-5)


def test_scaling_bench_on_the_world(runs):
    """measure_tp_decode over model 4 and measure_dp_step over data 4 (CPU
    timings: the keys and signs, no speed), and ep_scaling's executed
    part, which holds EP to the single-device layer."""
    from physics_llm_inference_tpu_torch.bench import scaling
    _, got = runs
    for out in got:
        tp, dp = out["scaling"]
        assert set(tp) == {4} and tp[4]["step_ms"] > 0
        assert 0 <= tp[4]["collective_share"] <= 1
        assert dp[4]["tokens_per_step"] == 8 and dp[4]["step_ms"] > 0
        assert out["ep_scaling"]["parity"] and out["ep_scaling"]["ranks"] == 4
    joined = scaling.add_efficiency({1: {"step_ms": 4.0}, 2: {"step_ms": 2.5}})
    assert joined[2]["efficiency"] == pytest.approx(0.8)


def test_predictions_follow_the_jax_shape():
    from physics_llm_inference_tpu.bench import scaling as jscaling
    from physics_llm_inference_tpu_torch.bench import ep_scaling, scaling
    cfg = TModelConfig(**CFG)
    pred = scaling.predict_scaling(cfg, mesh_sizes=(1, 4, 16))
    jpred = jscaling.predict_scaling(ModelConfig(**CFG), mesh_sizes=(1, 4, 16))
    assert set(pred) == set(jpred)
    for n in pred:
        assert set(pred[n]) == set(jpred[n])
        assert 0 < pred[n]["efficiency"] <= 1.0
    assert pred[1]["comm_ms"] == 0.0 and pred[1]["efficiency"] == 1.0
    dp = scaling.predict_dp_scaling(cfg)
    jdp = jscaling.predict_dp_scaling(ModelConfig(**CFG))
    assert set(dp[2]) == set(jdp[2])
    assert dp[1]["broadcast_ms"] == 0.0 and dp[16]["efficiency"] < 1.0
    rows = ep_scaling.predicted()
    assert [r["ep"] for r in rows] == [1, 2, 4, 8]
    assert rows[0]["a2a_ms"] == 0.0 and rows[1]["hbm_ms"] < rows[0]["hbm_ms"]


# ------------------------------------------------- no process group needed

def _split_dim(spec, ndim):
    """A JAX PartitionSpec's 'model' dim, counted from the end, or None."""
    for j, a in enumerate(spec):
        if a == "model":
            return j - ndim
    return None


def test_tp_param_spec_tree_matches_jax():
    from physics_llm_inference_tpu.models import quantize_params_int8
    params = quantize_params_int8(init_params(jax.random.PRNGKey(0),
                                              ModelConfig(**CFG)))
    jspec = jtp.tp_param_spec_tree(params)
    tparams = params_from_jax(to_numpy(params), device="cpu")
    tspec = tpar.tp_param_spec_tree(tparams)
    leaves = {("embed",): None, ("lm_head",): None, ("norm",): None}
    leaves.update({("blocks", k): None for k in params["blocks"]})
    for path in leaves:
        jl, tl, pl = jspec, tspec, tparams
        for k in path:
            jl, tl, pl = jl[k], tl[k], pl[k]
        if isinstance(pl, QuantizedTensor):
            for js, ts, arr in zip(jl, tl, pl):
                want = _split_dim(js, arr.dim())
                assert (None if ts is None else ts % arr.dim() - arr.dim()) \
                    == want, path
        else:
            assert (None if tl is None else tl % pl.dim() - pl.dim()) == \
                _split_dim(jl, pl.dim()), path


@pytest.mark.parametrize("quantized,merged", [(False, False), (True, False),
                                              (True, True)])
def test_tp_kv_spec_matches_jax(quantized, merged):
    def dims(spec):
        return {a: j for j, a in enumerate(spec) if a is not None}

    j = jtp.tp_kv_spec(quantized, paged_merged=merged)
    t = tpar.tp_kv_spec(quantized, paged_merged=merged)
    if quantized:
        assert dims(j.q) == t.q and dims(j.s) == t.s
    else:
        assert dims(j) == t


def test_tp_prepare_params_refuses_int4():
    w = QuantizedTensor4(torch.zeros((1, 8, 4), dtype=torch.int8),
                         torch.ones((1, 1, 8)))
    cfg = TModelConfig(**CFG)
    with pytest.raises(ValueError, match="INT4"):
        tpar.tp_prepare_params({"embed": torch.zeros(4, 4),
                                "blocks": {"wqkv": w}}, cfg, mesh=None)


def test_tp_local_config_and_memory_savings():
    cfg = TModelConfig(**CFG)
    local = tpar.tp_local_config(cfg, 2, mesh=None)
    jlocal = tp_local_config(ModelConfig(**CFG), 2)
    for f in ("num_heads", "num_kv_heads", "intermediate_dim", "head_dim",
              "tp_axis", "tp_data_axis", "vocab_size"):
        assert getattr(local, f) == getattr(jlocal, f), f
    with pytest.raises(ValueError):
        tpar.tp_local_config(cfg, 3)
    assert tpar.compute_tp_memory_savings(7_000_000_000, 8, 2) == \
        jtp.compute_tp_memory_savings(7_000_000_000, 8, 2)


def test_cost_model_at_one_set_of_inputs():
    """The byte formulas and the ring model are the JAX package's; the
    NVLink model's numbers at 1 MiB over 8 devices follow from its
    data-sheet constants."""
    d, n = 1 << 20, 8
    for f in ("all_reduce_bytes", "all_gather_bytes",
              "reduce_scatter_bytes", "all_to_all_bytes"):
        assert getattr(nvlink, f)(d, n) == getattr(ici, f)(d, n)
        assert getattr(nvlink, f)(d, 1) == 0.0
    assert nvlink.ring_all_reduce_time(d, n, 450e9, 2e-6) == \
        ici.ring_all_reduce_time(d, n, 450e9, 2e-6)
    assert nvlink.overlap_potential(1.0, 4.0) == \
        ici.overlap_potential(1.0, 4.0) == 0.25
    m = nvlink.CollectiveCostModel()
    assert m.all_reduce_time(d, n) == pytest.approx(14 * (2e-6 + d / (n *
                                                                   450e9)))
    assert m.all_to_all_time(d, n) == pytest.approx(7 * 2e-6 + d * 7 / 8 /
                                                    450e9)
    assert nvlink.CollectiveCostModel(pcie=True).all_reduce_time(d, n) > \
        m.all_reduce_time(d, n)
    assert m.tp_layer_comm_time(4096, 8, 2) == pytest.approx(
        2 * m.all_reduce_time(8 * 4096 * 2, 2))
    assert 0 < m.scaling_efficiency(1e-3, d, n) <= 1.0
