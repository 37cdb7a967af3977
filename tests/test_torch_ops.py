"""Plain ops of the port against the JAX package, in fp32 on the same numpy
inputs: atol/rtol 1e-5, int8 values exactly equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.kernels import quant as jquant
from physics_llm_inference_tpu.models import transformer as jtf
from physics_llm_inference_tpu.ops import norms as jnorms
from physics_llm_inference_tpu.ops import rope as jrope
from physics_llm_inference_tpu.ops import sampling as jsamp
from physics_llm_inference_tpu_torch.kernels import quant as tquant
from physics_llm_inference_tpu_torch.models import transformer as ttf
from physics_llm_inference_tpu_torch.ops import norms as tnorms
from physics_llm_inference_tpu_torch.ops import rope as trope
from physics_llm_inference_tpu_torch.ops import sampling as tsamp
from physics_llm_inference_tpu_torch.runtime import generate as tgen
from physics_llm_inference_tpu_torch.runtime import step_cache as tstep
from physics_llm_inference_tpu.runtime import generate as jgen
from torch_parity import t2n

TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_rms_norm():
    rng = _rng()
    x = rng.normal(0, 2, (3, 5, 64)).astype(np.float32)
    w = rng.normal(1, 0.1, (64,)).astype(np.float32)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)


def test_rope_tables_and_apply():
    rng = _rng(1)
    jc, js = jrope.rope_frequencies(32, 64, 10000.0)
    tc, ts = trope.rope_frequencies(32, 64, 10000.0)
    np.testing.assert_allclose(t2n(tc), np.asarray(jc), **TOL)
    np.testing.assert_allclose(t2n(ts), np.asarray(js), **TOL)
    x = rng.normal(0, 1, (2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 7))
    want = jrope.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos))
    got = trope.apply_rope(torch.from_numpy(x), tc, ts, torch.from_numpy(pos))
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_valid_from", [False, True])
def test_grouped_sdpa_with_attend_mask(with_valid_from):
    rng = _rng(2)
    b, hq, hkv, sq, sk, d = 2, 8, 2, 5, 9, 16
    q = rng.normal(0, 1, (b, hq, sq, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, sk, d)).astype(np.float32)
    q_slots = np.array([[4, 5, 6, 7, 8], [2, 3, 4, 5, 6]])
    k_slots = np.arange(sk)
    vf = np.array([1, 3], np.int32) if with_valid_from else None
    want = jtf._attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(q_slots), jnp.asarray(k_slots),
                       None if vf is None else jnp.asarray(vf))
    got = ttf._attend(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), torch.from_numpy(q_slots),
                      torch.from_numpy(k_slots),
                      None if vf is None else torch.from_numpy(vf))
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("axis", [-1, 0, (1, 2)])
def test_quantize_int8_exact(axis):
    rng = _rng(3)
    x = rng.normal(0, 3, (6, 5, 32)).astype(np.float32)
    x[0, 0, :4] = [0.5, -0.5, 1.5, 2.5]   # round-half-even cases
    jq, js = jquant.quantize_int8(jnp.asarray(x), axis=axis)
    tq, ts = tquant.quantize_int8(torch.from_numpy(x), axis=axis)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(t2n(tq), np.asarray(jq))
    np.testing.assert_allclose(t2n(ts), np.asarray(js), **TOL)
    np.testing.assert_allclose(
        t2n(tquant.dequantize_int8(tq, ts)),
        np.asarray(jquant.dequantize_int8(jq, js)), **TOL)


def test_sample_token_greedy():
    rng = _rng(4)
    logits = rng.normal(0, 1, (4, 50)).astype(np.float32)
    logits[1, 7] = logits[1, 30] = 9.0   # tie: the first index wins
    want = jsamp.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                              temperature=0.0)
    got = tsamp.sample_token(torch.from_numpy(logits), torch.Generator(),
                             temperature=0.0)
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


@pytest.mark.parametrize("k", [1, 5, 17])
def test_top_k_filter(k):
    logits = _rng(5).normal(0, 1, (3, 40)).astype(np.float32)
    want = jsamp._apply_top_k(jnp.asarray(logits), k)
    got = tsamp._apply_top_k(torch.from_numpy(logits), k)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_top_p_filter(p):
    logits = _rng(6).normal(0, 2, (3, 40)).astype(np.float32)
    want = jsamp._apply_top_p(jnp.asarray(logits), jnp.float32(p))
    got = tsamp._apply_top_p(torch.from_numpy(logits), torch.tensor(p))
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)


def test_sampled_ids_respect_filters():
    logits = torch.from_numpy(_rng(7).normal(0, 1, (64, 30)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    ids = tsamp.sample_token(logits, g, temperature=1.0, top_k=3)
    allowed = torch.topk(logits, 3, dim=-1).indices
    assert bool((allowed == ids[:, None]).any(dim=-1).all())


def test_pad_and_stack_and_buckets():
    prompts = [[3, 4], [5, 6, 7, 8, 9]]
    jids, jlens = jgen.pad_and_stack(prompts, pad_id=1)
    tids, tlens = tgen.pad_and_stack(prompts, pad_id=1)
    np.testing.assert_array_equal(t2n(tids), np.asarray(jids))
    np.testing.assert_array_equal(t2n(tlens), np.asarray(jlens))
    assert tstep.bucket_for(17, tstep.DEFAULT_SEQ_BUCKETS) == 32
    with pytest.raises(ValueError):
        tstep.bucket_for(10_000, tstep.DEFAULT_SEQ_BUCKETS)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("per_request", [False, True])
def test_cache_write_and_read_match_reference(quant, per_request):
    from physics_llm_inference_tpu.models.transformer import QuantKV as JQ
    rng = _rng(8)
    L, B, S, H, hd, s = 2, 3, 10, 2, 8, 3
    new = rng.normal(0, 1, (B, s, H, hd)).astype(np.float32)
    start = np.array([0, 4, 7]) if per_request else 5
    if quant:
        jc = JQ(jnp.zeros((L, B, S, H * hd), jnp.int8),
                jnp.zeros((L, B, H, S), jnp.float32))
        tc = ttf.QuantKV(torch.zeros((L, B, S, H * hd), dtype=torch.int8),
                         torch.zeros((L, B, H, S)))
    else:
        jc = jnp.zeros((L, B, S, H, hd), jnp.float32)
        tc = torch.zeros((L, B, S, H, hd))
    jc = jtf._cache_write(jc, jnp.asarray(new), jnp.asarray(start),
                          layer=jnp.int32(1))
    tstart = torch.from_numpy(start) if per_request else start
    out = ttf._cache_write(tc, torch.from_numpy(new), tstart, layer=1)
    assert out is tc  # written in place
    want = jtf._cache_read_layer(jc, jnp.int32(1), jnp.float32)
    got = ttf._cache_read_layer(tc, 1, torch.float32)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(t2n(ttf._cache_read(tc, torch.float32)),
                               np.asarray(jtf._cache_read(jc, jnp.float32)),
                               **TOL)
