"""Weights and caches carried from the JAX package to the port: shapes,
dtypes and values equal; the port's own quantizer and INT8 init agree with
the reference's layouts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.models.config import ModelConfig as JConfig
from physics_llm_inference_tpu.models.quant import \
    init_params_int8 as j_init_int8
from physics_llm_inference_tpu.models.quant import \
    quantize_params_int8 as j_quantize
from physics_llm_inference_tpu.models.transformer import init_params
from physics_llm_inference_tpu_torch.models.transformer import \
    init_params as t_init_params
from physics_llm_inference_tpu.runtime.kv_cache import KVCache as JKVCache
from physics_llm_inference_tpu_torch.convert import kv_from_jax, params_from_jax
from physics_llm_inference_tpu_torch.models.config import ModelConfig as TConfig
from physics_llm_inference_tpu_torch.models.quant import (
    QuantizedTensor, init_params_int8, quantize_params_int8)
from physics_llm_inference_tpu_torch.models.transformer import QuantKV
from physics_llm_inference_tpu_torch.runtime.kv_cache import (
    KVCache, calculate_kv_cache_size)
from torch_parity import t2n, to_numpy

DIMS = dict(vocab_size=256, hidden_dim=128, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_dim=256, max_seq_len=64)


def _pairs(jtree, ttree):
    """(name, jax leaf, port leaf) over the parameter dict, quantized leaves
    split into their q and s parts."""
    flat_j = {"embed": jtree["embed"], "norm": jtree["norm"],
              "lm_head": jtree["lm_head"],
              **{f"blocks.{k}": v for k, v in jtree["blocks"].items()}}
    flat_t = {"embed": ttree["embed"], "norm": ttree["norm"],
              "lm_head": ttree["lm_head"],
              **{f"blocks.{k}": v for k, v in ttree["blocks"].items()}}
    assert flat_j.keys() == flat_t.keys()
    for name, jl in flat_j.items():
        tl = flat_t[name]
        if hasattr(jl, "q"):
            assert isinstance(tl, QuantizedTensor)
            yield f"{name}.q", jl.q, tl.q
            yield f"{name}.s", jl.s, tl.s
        else:
            yield name, jl, tl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip(dtype):
    cfg = JConfig(dtype=dtype, **DIMS)
    jparams = j_quantize(init_params(jax.random.PRNGKey(0), cfg))
    tparams = params_from_jax(to_numpy(jparams), device="cpu")
    for name, jl, tl in _pairs(jparams, tparams):
        assert tuple(tl.shape) == jl.shape, name
        assert str(tl.dtype).removeprefix("torch.") == str(jl.dtype), name
        np.testing.assert_array_equal(t2n(tl), np.asarray(jl, np.float32)
                                      if tl.is_floating_point()
                                      else np.asarray(jl), err_msg=name)
    assert tparams["lm_head"].s.shape == (1, DIMS["vocab_size"])


def test_int8_kv_cache_round_trip():
    cfg = JConfig(**DIMS)
    jcache = JKVCache.create(cfg, 3, 16, dtype=jnp.int8)
    rng = np.random.default_rng(0)
    jcache = jcache._replace(
        k=jcache.k._replace(q=jnp.asarray(
            rng.integers(-127, 128, jcache.k.q.shape), jnp.int8)),
        v=jcache.v._replace(s=jnp.asarray(
            rng.uniform(0, 1, jcache.v.s.shape), jnp.float32)),
        length=jnp.int32(5))
    tcache = kv_from_jax(to_numpy(jcache), device="cpu")
    assert isinstance(tcache.k, QuantKV) and tcache.length == 5
    for jpart, tpart in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
        for jl, tl in zip(jpart, tpart):
            assert tuple(tl.shape) == jl.shape
            np.testing.assert_array_equal(t2n(tl), np.asarray(jl))
    # the port's own cache has the same layouts
    own = KVCache.create(TConfig(**DIMS), 3, 16, dtype=torch.int8)
    assert own.k.q.shape == tcache.k.q.shape and own.k.q.dtype == torch.int8
    assert own.k.s.shape == tcache.k.s.shape and own.k.s.dtype == torch.float32
    sizes = calculate_kv_cache_size(3, 16, DIMS["num_layers"],
                                    DIMS["num_kv_heads"], 32, dtype_bytes=1)
    assert sizes["total_bytes"] == own.k.q.numel() + own.v.q.numel()


def test_quantize_params_int8_matches_reference():
    cfg = JConfig(**DIMS)
    dense = init_params(jax.random.PRNGKey(1), cfg)
    jq = j_quantize(dense)
    tq = quantize_params_int8(params_from_jax(to_numpy(dense), device="cpu"))
    for name, jl, tl in _pairs(jq, tq):
        np.testing.assert_allclose(t2n(tl), np.asarray(jl, np.float32),
                                   rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layouts_match_reference(dtype):
    cfg = JConfig(dtype=dtype, **DIMS)
    jshapes = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
    tparams = t_init_params(torch.Generator().manual_seed(0),
                            TConfig(dtype=dtype, **DIMS))
    for name, jl, tl in _pairs(jshapes, tparams):
        assert tuple(tl.shape) == jl.shape, name
        assert str(tl.dtype).removeprefix("torch.") == str(jl.dtype), name
    std = float(tparams["blocks"]["w_down"].float().std())
    assert abs(std * DIMS["intermediate_dim"] ** 0.5 - 1.0) < 0.05


def test_init_params_int8_layouts_match_reference():
    cfg = JConfig(dtype="bfloat16", **DIMS)
    jshapes = jax.eval_shape(lambda: j_init_int8(jax.random.PRNGKey(0), cfg))
    gen = torch.Generator().manual_seed(0)
    tparams = init_params_int8(gen, TConfig(dtype="bfloat16", **DIMS))
    for name, jl, tl in _pairs(jshapes, tparams):
        assert tuple(tl.shape) == jl.shape, name
        assert str(tl.dtype).removeprefix("torch.") == str(jl.dtype), name
    q = tparams["blocks"]["w_gate_up"].q
    assert int(q.min()) >= -127 and int(q.max()) <= 127
    # dequantized std ~ fan_in ** -0.5, as in the reference
    std = float(tparams["blocks"]["wqkv"].dequantize(torch.float32).std())
    assert abs(std * DIMS["hidden_dim"] ** 0.5 - 1.0) < 0.05
    again = init_params_int8(torch.Generator().manual_seed(0),
                             TConfig(dtype="bfloat16", **DIMS))
    assert torch.equal(again["blocks"]["wo"].q, tparams["blocks"]["wo"].q)


def test_int4_params_round_trip_and_malformed_leaves_raise():
    from physics_llm_inference_tpu.models.quant import \
        quantize_params_int4 as j_quantize4
    from physics_llm_inference_tpu_torch.models.quant import QuantizedTensor4

    cfg = JConfig(dtype="bfloat16", **dict(DIMS, intermediate_dim=384))
    jparams = to_numpy(j_quantize4(init_params(jax.random.PRNGKey(2), cfg)))
    tparams = params_from_jax(jparams, device="cpu")
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        jl, tl = jparams["blocks"][name], tparams["blocks"][name]
        # the packed nibbles stay packed, the group scales stay group scales
        assert isinstance(tl, QuantizedTensor4), name
        for a, b in ((tl.q, jl.q), (tl.s, jl.s)):
            assert tuple(a.shape) == b.shape and t2n(a).dtype == b.dtype
            np.testing.assert_array_equal(t2n(a), b, err_msg=name)
    assert tparams["blocks"]["w_down"].group * 3 == 384   # 3 groups
    assert isinstance(tparams["lm_head"], QuantizedTensor)
    np.testing.assert_array_equal(t2n(tparams["lm_head"].q),
                                  jparams["lm_head"].q)

    w4 = jparams["blocks"]["wo"]
    w8 = to_numpy(j_quantize(init_params(jax.random.PRNGKey(2), cfg)))[
        "blocks"]["wo"]
    bad = {
        # packed int4 bytes under the int8 type: scales wider than the rows
        "int4 bytes as int8": type(w8)(w4.q, w4.s),
        # int8 codes under the int4 type: rows as wide as the scales
        "int8 codes as int4": type(w4)(w8.q, w8.s),
        "groups not dividing K": type(w4)(w4.q, np.concatenate(
            [w4.s] * 3, axis=1)),
        "f32 values": type(w8)(w8.q.astype(np.float32), w8.s),
    }
    for what, leaf in bad.items():
        tree = dict(jparams, blocks=dict(jparams["blocks"], wo=leaf))
        with pytest.raises(ValueError, match="layout"):
            params_from_jax(tree, device="cpu")
