"""INT4 (W4A16) weights in the port against the JAX package: the packed
format and its unpacking, the quantizer (absmax and the MSE scale search),
the group size, the fused-decode gate, the INT4 prefill linear and greedy
generation on the per-op path that both packages take on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.kernels.fused_decode import \
    int4_group_size as j_group
from physics_llm_inference_tpu.models import config as jcfg_mod
from physics_llm_inference_tpu.models import quant as jq
from physics_llm_inference_tpu.models import transformer as jtf
from physics_llm_inference_tpu.runtime import generate as jgen
from physics_llm_inference_tpu.runtime.kv_cache import KVCache as JKVCache
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.kernels.fused_decode import \
    int4_group_size as t_group
from physics_llm_inference_tpu_torch.models import config as tcfg_mod
from physics_llm_inference_tpu_torch.models import quant as tq
from physics_llm_inference_tpu_torch.models import transformer as ttf
from physics_llm_inference_tpu_torch.runtime import generate as tgen
from physics_llm_inference_tpu_torch.runtime.kv_cache import \
    KVCache as TKVCache
from torch_parity import assert_close, t2n, to_numpy

# head_dim 128, so the fused gate can pass; w_down (K = 768) has 3 scale
# groups of 256
SLICE = dict(vocab_size=512, hidden_dim=512, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_dim=768, max_seq_len=128,
             fused_decode=False, attention_impl="dense")
NEW_TOKENS = 8


def _dense(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _unpack_jax(q):
    lo = jnp.right_shift(jnp.left_shift(q, 4), 4)
    return jnp.concatenate([lo, jnp.right_shift(q, 4)], axis=-1)


@pytest.mark.parametrize("group", [64, 128])
def test_pack_unpack_and_dequantize_bit_equal(group):
    w = _dense((2, 256, 96), 0)
    j4 = jq._quantize_stacked_int4(jnp.asarray(w), group)
    t4 = tq._quantize_stacked_int4(torch.from_numpy(w), group)
    # the port's packing of the same codes: the same bytes and scales
    np.testing.assert_array_equal(t2n(t4.q), np.asarray(j4.q))
    np.testing.assert_array_equal(t2n(t4.s), np.asarray(j4.s))
    assert t4.shape == j4.shape and t4.group == j4.group == group
    # unpacking the JAX bytes: channel j low nibble, N/2 + j high nibble
    got = tq.unpack_int4(torch.from_numpy(np.asarray(j4.q)))
    np.testing.assert_array_equal(t2n(got), np.asarray(_unpack_jax(j4.q)))
    assert int(got.min()) >= -8 and int(got.max()) <= 7
    t = tq.QuantizedTensor4(torch.from_numpy(np.asarray(j4.q)),
                            torch.from_numpy(np.asarray(j4.s)))
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(t2n(t.dequantize(td)),
                                      np.asarray(j4.dequantize(jd), np.float32))
        np.testing.assert_array_equal(
            t2n(t.dequantize_layer(1, td)),
            np.asarray(j4.dequantize_layer(1, jd), np.float32))


def _dense_params(dtype="float32", seed=0):
    jcfg = jcfg_mod.ModelConfig(dtype=dtype, **SLICE)
    return jcfg, jtf.init_params(jax.random.PRNGKey(seed), jcfg)


def test_quantize_params_int4_matches_reference():
    _, dense = _dense_params()
    j4 = jq.quantize_params_int4(dense)
    t4 = tq.quantize_params_int4(params_from_jax(to_numpy(dense),
                                                 device="cpu"))
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        jl, tl = j4["blocks"][name], t4["blocks"][name]
        assert isinstance(tl, tq.QuantizedTensor4), name
        np.testing.assert_array_equal(t2n(tl.q), np.asarray(jl.q),
                                      err_msg=name)
        np.testing.assert_array_equal(t2n(tl.s), np.asarray(jl.s),
                                      err_msg=name)
    assert t4["blocks"]["w_down"].s.shape[1] == 3
    # the lm_head stays int8, quantized as the INT8 format does
    assert isinstance(t4["lm_head"], tq.QuantizedTensor)
    np.testing.assert_array_equal(t2n(t4["lm_head"].q),
                                  np.asarray(j4["lm_head"].q))
    np.testing.assert_allclose(t2n(t4["lm_head"].s),
                               np.asarray(j4["lm_head"].s), rtol=1e-6)
    # an INT8 tree is dequantized first, as in the reference
    from_int8 = tq.quantize_params_int4(tq.quantize_params_int8(
        params_from_jax(to_numpy(dense), device="cpu")))
    assert isinstance(from_int8["blocks"]["wo"], tq.QuantizedTensor4)


def test_quantize_mse_picks_the_same_scales():
    w = _dense((2, 512, 256), 1)
    w[:, ::37] *= 6.0                   # outliers, so the search moves scales
    j4 = jq._quantize_stacked_int4(jnp.asarray(w), 128, mse=True)
    t4 = tq._quantize_stacked_int4(torch.from_numpy(w), 128, mse=True)
    same = (t2n(t4.s) == np.asarray(j4.s)).mean()
    assert same >= 0.99, same
    plain = tq._quantize_stacked_int4(torch.from_numpy(w), 128)
    assert (t2n(plain.s) != t2n(t4.s)).any()

    def rel(d):
        return float(np.linalg.norm(d - w) / np.linalg.norm(w))

    rt = rel(t2n(t4.dequantize(torch.float32)))
    rj = rel(np.asarray(j4.dequantize(jnp.float32)))
    assert abs(rt - rj) <= 1e-3
    assert rt < rel(t2n(plain.dequantize(torch.float32)))


@pytest.mark.parametrize("k,n", [(4096, 6144), (4096, 4096), (4096, 22016),
                                 (11008, 4096), (512, 1024), (768, 512),
                                 (512, 2048), (1024, 1536), (24, 16)])
def test_group_size_matches_reference(k, n):
    assert t_group(k, n) == j_group(k, n)


def test_init_params_int4_layouts_match_reference():
    cfg = dict(SLICE, dtype="bfloat16")
    jshapes = jax.eval_shape(lambda: jq.init_params_int4(
        jax.random.PRNGKey(0), jcfg_mod.ModelConfig(**cfg)))
    tp = tq.init_params_int4(torch.Generator().manual_seed(0),
                             tcfg_mod.ModelConfig(**cfg))
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        jl, tl = jshapes["blocks"][name], tp["blocks"][name]
        assert isinstance(tl, tq.QuantizedTensor4), name
        assert tuple(tl.q.shape) == jl.q.shape and tl.q.dtype == torch.int8
        assert tuple(tl.s.shape) == jl.s.shape and tl.s.dtype == torch.float32
    assert tuple(tp["lm_head"].q.shape) == jshapes["lm_head"].q.shape
    assert tuple(tp["lm_head"].s.shape) == jshapes["lm_head"].s.shape
    # dequantized std ~ fan_in ** -0.5, as in the reference
    std = float(tp["blocks"]["wqkv"].dequantize(torch.float32).std())
    assert abs(std * SLICE["hidden_dim"] ** 0.5 - 1.0) < 0.05
    # the byte accounting of the reference
    jb = jq.quantized_param_bytes(jq.init_params_int4(
        jax.random.PRNGKey(0), jcfg_mod.ModelConfig(**cfg)))
    assert tq.quantized_param_bytes(tp) == jb


def _gate_cases():
    """(name, JAX tree, cfg overrides) for int8, int4, mixed and W4A8."""
    _, dense = _dense_params("bfloat16")
    p8, p4 = jq.quantize_params_int8(dense), jq.quantize_params_int4(dense)
    mixed = dict(p4, blocks=dict(p4["blocks"], wo=p8["blocks"]["wo"]))
    return [("int8", p8, {}), ("int4", p4, {}), ("mixed", mixed, {}),
            ("w8a8", p8, {"act_quant": "int8"}),
            ("w4a8", p4, {"act_quant": "int8"})]


@pytest.mark.parametrize("case", range(5))
def test_fused_decode_gate_agrees_with_reference(case, monkeypatch):
    name, jparams, over = _gate_cases()[case]
    cfg = dict(SLICE, dtype="bfloat16", fused_decode=True,
               attention_impl="auto", **over)
    jcfg, tcfg = jcfg_mod.ModelConfig(**cfg), tcfg_mod.ModelConfig(**cfg)
    tparams = params_from_jax(to_numpy(jparams), device="cpu")
    # the JAX gate also asks for a TPU backend; the port's asks for a CUDA
    # tensor at its call site instead
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for b in (8, 4):
        jkv = JKVCache.create(jcfg, b, 32, dtype=jnp.int8).as_slice()
        tkv = TKVCache.create(tcfg, b, 32, dtype=torch.int8).as_slice()
        want = jtf._fused_decode_ok(jparams, jcfg, b, jkv)
        assert ttf._fused_decode_ok(tparams, tcfg, b, tkv) == want, (name, b)
        # b % 8 decides for the kernel's modes; mixed stacks and W4A8 never
        assert want == (b == 8 and name in ("int8", "int4", "w8a8"))


def _int4_models(dtype):
    jcfg, dense = _dense_params(dtype)
    tcfg = tcfg_mod.ModelConfig(dtype=dtype, **SLICE)
    jparams = jq.quantize_params_int4(dense)
    return jcfg, tcfg, jparams, params_from_jax(to_numpy(jparams),
                                                device="cpu")


def _prompts():
    rng = np.random.default_rng(0)
    return [list(rng.integers(1, SLICE["vocab_size"], n)) for n in (5, 11, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_prefill_logits_match(dtype):
    """The INT4 branch of `_linear` (dequantize, f32-output product, cast)
    under the whole prefill."""
    jcfg, tcfg, jparams, tparams = _int4_models(dtype)
    jids, jlens = jgen.pad_and_stack(_prompts())
    tids, tlens = tgen.pad_and_stack(_prompts())
    b, p = jids.shape
    jcache = JKVCache.create(jcfg, b, p + NEW_TOKENS, dtype=jnp.int8)
    tcache = TKVCache.create(tcfg, b, p + NEW_TOKENS, dtype=torch.int8)
    jl, _, _ = jgen._prefill(jparams, jcfg, jids, jlens, jcache.as_slice())
    tl, _, _ = tgen._prefill(tparams, tcfg, tids, tlens, tcache.as_slice())
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert_close(t2n(tl), jl, dtype)


def test_int4_greedy_tokens_identical_fp32():
    jcfg, tcfg, jparams, tparams = _int4_models("float32")
    jout = jgen.cached_generate(jparams, jcfg, _prompts(), NEW_TOKENS,
                                temperature=0.0, kv_dtype=jnp.int8)
    tout = tgen.cached_generate(tparams, tcfg, _prompts(), NEW_TOKENS,
                                temperature=0.0, kv_dtype=torch.int8)
    assert tout.tokens.shape == (3, NEW_TOKENS)
    np.testing.assert_array_equal(tout.tokens, jout.tokens)
    np.testing.assert_array_equal(tout.gen_lens, jout.gen_lens)


def test_int4_layer_view_and_w4a8_stay_per_op_on_cpu():
    """forward with INT4 stacks on the CPU: layer views keep the type, the
    gate passes W4A16 and refuses W4A8, and decode runs the per-op path
    (no fused launch of any mode)."""
    from physics_llm_inference_tpu_torch.kernels import fused_decode as t_fd

    cfg = tcfg_mod.ModelConfig(**dict(SLICE, dtype="bfloat16",
                                      fused_decode=True,
                                      attention_impl="auto"))
    params = tq.init_params_int4(torch.Generator().manual_seed(0), cfg)
    view = ttf.layer_view(params["blocks"], 1)
    assert isinstance(view["w_down"], tq.QuantizedTensor4)
    assert torch.equal(view["w_down"].q, params["blocks"]["w_down"].q[1])
    cache = TKVCache.create(cfg, 8, 32, dtype=torch.int8)
    assert ttf._fused_decode_ok(params, cfg, 8, cache.as_slice())
    w4a8 = dataclasses.replace(cfg, act_quant="int8")
    assert not ttf._fused_decode_ok(params, w4a8, 8, cache.as_slice())
    tok, kv = ttf.forward(params, torch.ones((8, 1), dtype=torch.int64), cfg,
                          kv=cache.as_slice(), greedy_head=True)
    assert tok.shape == (8,) and kv.start == 1
    assert t_fd.launches == t_fd.w4a16_launches == t_fd.w8a8_launches == 0
