"""The ported slice as a whole: the JAX package's cached_generate (reference)
against the port's, on the same converted INT8 weights, INT8 KV cache,
per-op decode (fused_decode=False) and dense attention pinned on both sides
(`auto` picks its implementation from the cache capacity)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.models import config as jcfg_mod
from physics_llm_inference_tpu.models.quant import quantize_params_int8
from physics_llm_inference_tpu.models.transformer import init_params
from physics_llm_inference_tpu.runtime import generate as jgen
from physics_llm_inference_tpu.runtime.kv_cache import KVCache as JKVCache
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models import config as tcfg_mod
from physics_llm_inference_tpu_torch.runtime import generate as tgen
from physics_llm_inference_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from torch_parity import assert_close, t2n, to_numpy

SLICE = dict(vocab_size=512, hidden_dim=512, num_layers=2, num_heads=8,
             num_kv_heads=2, intermediate_dim=1024, max_seq_len=128,
             fused_decode=False, attention_impl="dense")
NEW_TOKENS = 8


def _prompts():
    rng = np.random.default_rng(0)
    return [list(rng.integers(1, SLICE["vocab_size"], n)) for n in (5, 11, 16)]


def _models(dtype: str):
    jcfg = jcfg_mod.ModelConfig(dtype=dtype, **SLICE)
    tcfg = tcfg_mod.ModelConfig(dtype=dtype, **SLICE)
    jparams = quantize_params_int8(init_params(jax.random.PRNGKey(0), jcfg))
    tparams = params_from_jax(to_numpy(jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prefill_logits(jcfg, tcfg, jparams, tparams):
    jids, jlens = jgen.pad_and_stack(_prompts())
    tids, tlens = tgen.pad_and_stack(_prompts())
    b, p = jids.shape
    jcache = JKVCache.create(jcfg, b, p + NEW_TOKENS, dtype=jnp.int8)
    tcache = TKVCache.create(tcfg, b, p + NEW_TOKENS, dtype=torch.int8)
    jl, jkv, _ = jgen._prefill(jparams, jcfg, jids, jlens, jcache.as_slice())
    tl, tkv, _ = tgen._prefill(tparams, tcfg, tids, tlens, tcache.as_slice())
    return jl, tl, jkv, tkv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match(dtype):
    jl, tl, jkv, tkv = _prefill_logits(*_models(dtype))
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert_close(t2n(tl), jl, dtype)
    if dtype == "float32":
        # the INT8 cache the prefill wrote: values off by at most one level
        # where the f32 sums round across a .5 boundary
        jq = np.asarray(jkv.k.q, np.int32)
        tq = t2n(tkv.k.q).astype(np.int32)
        assert np.abs(jq - tq).max() <= 1 and (jq != tq).mean() < 1e-3
        np.testing.assert_allclose(t2n(tkv.k.s), np.asarray(jkv.k.s),
                                   rtol=1e-5, atol=1e-7)


def test_greedy_tokens_identical_fp32():
    jcfg, tcfg, jparams, tparams = _models("float32")
    jout = jgen.cached_generate(jparams, jcfg, _prompts(), NEW_TOKENS,
                                temperature=0.0, kv_dtype=jnp.int8)
    tout = tgen.cached_generate(tparams, tcfg, _prompts(), NEW_TOKENS,
                                temperature=0.0, kv_dtype=torch.int8)
    assert tout.tokens.shape == (3, NEW_TOKENS)
    np.testing.assert_array_equal(tout.tokens, jout.tokens)
    np.testing.assert_array_equal(tout.prompt_lens, jout.prompt_lens)
    np.testing.assert_array_equal(tout.gen_lens, jout.gen_lens)


def test_stop_tokens_pad_like_reference():
    jcfg, tcfg, jparams, tparams = _models("float32")
    jref = jgen.cached_generate(jparams, jcfg, _prompts(), NEW_TOKENS,
                                temperature=0.0, kv_dtype=jnp.int8)
    stop = (int(jref.tokens[1, 2]),)
    jout = jgen.cached_generate(jparams, jcfg, _prompts(), NEW_TOKENS,
                                temperature=0.0, kv_dtype=jnp.int8,
                                stop_tokens=stop)
    tout = tgen.cached_generate(tparams, tcfg, _prompts(), NEW_TOKENS,
                                temperature=0.0, kv_dtype=torch.int8,
                                stop_tokens=stop)
    np.testing.assert_array_equal(tout.tokens, jout.tokens)
    np.testing.assert_array_equal(tout.gen_lens, jout.gen_lens)


def test_unported_paths_are_refused_not_substituted():
    from physics_llm_inference_tpu_torch.models import transformer as ttf
    from physics_llm_inference_tpu_torch.models.quant import init_params_int8
    from physics_llm_inference_tpu_torch.runtime.kv_cache import KVCache

    # the 7B slice's shapes: the port picks flash attention exactly where
    # the JAX package would (prefill from 512 tokens of context), and only
    # on the card
    big = tcfg_mod.ModelConfig(vocab_size=32000, hidden_dim=4096,
                               num_layers=32, num_heads=32, num_kv_heads=8,
                               intermediate_dim=11008)
    assert ttf._resolve_attention(big, 64, 128, None, on_cuda=True) == "dense"
    assert ttf._resolve_attention(big, 64, 512, None, on_cuda=True) == "flash"
    assert ttf._resolve_attention(big, 64, 512, None, on_cuda=False) == "dense"

    small = tcfg_mod.ModelConfig(vocab_size=256, hidden_dim=256,
                                 num_layers=1, num_heads=2, num_kv_heads=1,
                                 intermediate_dim=256, dtype="float32")
    params = init_params_int8(torch.Generator().manual_seed(0), small)
    cache = KVCache.create(small, 8, 16, dtype=torch.int8)
    assert ttf._fused_decode_ok(params, small, 8, cache.as_slice())
    per_op = tcfg_mod.ModelConfig(**{**small.__dict__, "fused_decode": False})
    assert not ttf._fused_decode_ok(params, per_op, 8, cache.as_slice())
    # on the CPU the gate is false, as on the JAX CPU backend: decode runs
    ids = torch.ones((8, 1), dtype=torch.int64)
    tok, _ = ttf.forward(params, ids, small, kv=cache.as_slice(),
                         greedy_head=True)
    assert tok.shape == (8,)

    # an MoE config runs forward on the per-op path: K4 has no MoE mode in
    # the reference, so the fused gate stays false on the INT8 tree and
    # cache that pass it densely; the decode step runs the routed FFN
    from physics_llm_inference_tpu_torch.models.quant import \
        quantize_params_int8
    moe = tcfg_mod.ModelConfig(**{**small.__dict__, "num_experts": 4})
    mparams = quantize_params_int8(ttf.init_params(
        torch.Generator().manual_seed(0), moe))
    assert "moe_w1" in mparams["blocks"] and \
        "w_gate_up" not in mparams["blocks"]
    assert not ttf._fused_decode_ok(mparams, moe, 8, cache.as_slice())
    tok, _ = ttf.forward(mparams, ids, moe, kv=cache.as_slice(),
                         greedy_head=True)
    assert tok.shape == (8,)
    # a TP local config runs forward through its hooks (the wo and down
    # all-reduces, the sharded embedding and the logits gather): on one
    # rank they are the identity, and the fused head stays shut
    from physics_llm_inference_tpu_torch.parallel.tp import tp_local_config
    from torch_dist_workers import OneRankMesh
    tp = tp_local_config(small, 1, mesh=OneRankMesh(data=1, model=1))
    ids = torch.ones((2, 4), dtype=torch.int64)
    np.testing.assert_array_equal(t2n(ttf.forward(params, ids, tp)[0]),
                                  t2n(ttf.forward(params, ids, small)[0]))


def test_uncached_forward_logits_match():
    jcfg, tcfg, jparams, tparams = _models("float32")
    from physics_llm_inference_tpu.models.transformer import forward as jfwd
    from physics_llm_inference_tpu_torch.models.transformer import \
        forward as tfwd

    ids = np.random.default_rng(1).integers(0, SLICE["vocab_size"], (2, 12))
    jl, _ = jfwd(jparams, jnp.asarray(ids, jnp.int32), jcfg)
    tl, _ = tfwd(tparams, torch.from_numpy(ids), tcfg)
    assert_close(t2n(tl), jl, "float32")


def test_dense_kv_cache_greedy_tokens_identical():
    jcfg, tcfg, jparams, tparams = _models("float32")
    jout = jgen.cached_generate(jparams, jcfg, _prompts(), 6,
                                temperature=0.0)
    tout = tgen.cached_generate(tparams, tcfg, _prompts(), 6,
                                temperature=0.0)
    np.testing.assert_array_equal(tout.tokens, jout.tokens)


def test_sampled_generation_runs_with_filters():
    _, tcfg, _, tparams = _models("float32")
    g = torch.Generator().manual_seed(0)
    out = tgen.cached_generate(tparams, tcfg, _prompts(), 4, generator=g,
                               temperature=0.8, top_k=20, top_p=0.9,
                               kv_dtype=torch.int8)
    assert out.tokens.shape == (3, 4) and out.tokens.dtype == np.int32
    assert out.tokens.min() >= 0 and out.tokens.max() < SLICE["vocab_size"]
    assert out.prefill_s > 0 and out.decode_s > 0


def test_step_cache_replays_decode_loop_with_identical_tokens():
    """The step-index form of the decode loop (start a (B,) tensor, the step
    index advanced on the device) kept in a step cache: a second call of
    the same shapes hits the cache and reuses its loop and KV cache, and
    both calls give the JAX package's fp32 greedy tokens."""
    jcfg, tcfg, jparams, tparams = _models("float32")
    jout = jgen.cached_generate(jparams, jcfg, _prompts(), NEW_TOKENS,
                                temperature=0.0, kv_dtype=jnp.int8)
    cache = tgen.decode_step_cache()
    for _ in range(2):
        tout = tgen.cached_generate(tparams, tcfg, _prompts(), NEW_TOKENS,
                                    temperature=0.0, kv_dtype=torch.int8,
                                    step_cache=cache)
        np.testing.assert_array_equal(tout.tokens, jout.tokens)
    assert cache.stats() == {"compiled_shapes": 1, "hits": 1, "misses": 1}
    # another stop set fixes another step: a new entry
    tgen.cached_generate(tparams, tcfg, _prompts(), NEW_TOKENS,
                         temperature=0.0, kv_dtype=torch.int8,
                         stop_tokens=(3,), step_cache=cache)
    assert cache.stats() == {"compiled_shapes": 2, "hits": 1, "misses": 2}


def test_step_cache_keys_sampled_loop_by_generator_device():
    """A sampled decode loop is keyed by its generator's device, not by the
    generator: new callers' generators from one seed share one entry, and
    each call draws as a call without the cache does from the same seed,
    leaving the caller's generator in the same state."""
    _, tcfg, _, tparams = _models("float32")
    kw = dict(temperature=0.8, top_k=20, top_p=0.9, kv_dtype=torch.int8)
    g = torch.Generator().manual_seed(7)
    want = tgen.cached_generate(tparams, tcfg, _prompts(), NEW_TOKENS,
                                generator=g, **kw).tokens
    want_state = g.get_state()
    cache = tgen.decode_step_cache()
    for _ in range(3):
        g = torch.Generator().manual_seed(7)
        got = tgen.cached_generate(tparams, tcfg, _prompts(), NEW_TOKENS,
                                   generator=g, step_cache=cache, **kw)
        np.testing.assert_array_equal(got.tokens, want)
        assert torch.equal(g.get_state(), want_state)
    assert cache.stats() == {"compiled_shapes": 1, "hits": 2, "misses": 1}
    # the caller's generator is left where the loop's draws left it
    (loop, _), = cache._cache.values()
    assert torch.equal(loop.generator.get_state(), want_state)
    assert not torch.equal(torch.Generator().manual_seed(7).get_state(),
                           want_state)


def test_decode_loop_cache_matches_jax_scan():
    """DecodeLoop stepped eagerly, each step's cache write at a start slot
    read from a (B,) tensor (the per-op path's indexed write), against the
    JAX package's _decode_jit scan from the same prefill: the same tokens,
    and the INT8 cache it leaves within one level (f32 sums that round
    across a .5 boundary, as the prefill test allows)."""
    jcfg, tcfg, jparams, tparams = _models("float32")
    jids, jlens = jgen.pad_and_stack(_prompts())
    b, p = jids.shape
    jcache = JKVCache.create(jcfg, b, p + NEW_TOKENS, dtype=jnp.int8)
    jl, jkv, jvf = jgen._prefill(jparams, jcfg, jids, jlens,
                                 jcache.as_slice())
    jfirst = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    jtoks, jkv = jgen._decode_jit(
        jparams, jcfg, jkv, jfirst, jlens, jvf, jax.random.PRNGKey(0),
        NEW_TOKENS, jnp.float32(0.0), 0, jnp.float32(1.0),
        jnp.zeros((1,), jnp.int32), 0, False, False, greedy=True,
        prompt_bucket=p)

    loop = tgen.DecodeLoop(tparams, tcfg, b, p + NEW_TOKENS, torch.int8,
                           True, 0, False, (), 0, None)
    tids, tlens = tgen.pad_and_stack(_prompts())
    tl, _, tvf = tgen._prefill(tparams, tcfg, tids, tlens,
                               loop.cache.as_slice())
    loop.begin(torch.argmax(tl, dim=-1), tlens, tvf, p, 0.0, 1.0)
    for _ in range(NEW_TOKENS):
        loop.step()
    assert int(loop.i) == NEW_TOKENS
    np.testing.assert_array_equal(t2n(loop.emitted)[:, :NEW_TOKENS],
                                  np.asarray(jtoks))
    for t, j in ((loop.cache.k, jkv.k), (loop.cache.v, jkv.v)):
        jq, tq = np.asarray(j.q, np.int32), t2n(t.q).astype(np.int32)
        assert np.abs(jq - tq).max() <= 1 and (jq != tq).mean() < 1e-3
        np.testing.assert_allclose(t2n(t.s), np.asarray(j.s), rtol=1e-5,
                                   atol=1e-7)
