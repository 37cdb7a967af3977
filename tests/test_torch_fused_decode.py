"""The port's fused whole-model decode step (kernels/fused_decode.py) against
the JAX package's Pallas kernel, run in interpret mode as the JAX package's
own tests run it on the CPU. On the CPU the port's entry point takes its
plain version, which mirrors the TPU kernel's numerics (f32 residual stream
across all layers); the CUDA kernel is held against that plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.kernels.fused_decode import \
    fused_decode_step as j_fused
from physics_llm_inference_tpu.models import config as jcfg_mod
from physics_llm_inference_tpu.models.quant import quantize_params_int8
from physics_llm_inference_tpu.models.transformer import \
    _scatter_new_kv as j_scatter
from physics_llm_inference_tpu.models.transformer import init_params
from physics_llm_inference_tpu.ops.rope import rope_frequencies as j_rope
from physics_llm_inference_tpu.runtime import generate as jgen
from physics_llm_inference_tpu.runtime.kv_cache import KVCache as JKVCache
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.kernels import fused_decode as t_fd
from physics_llm_inference_tpu_torch.models import config as tcfg_mod
from physics_llm_inference_tpu_torch.models import transformer as ttf
from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies
from torch_parity import t2n, to_numpy

# the config of tests/test_fused_decode.py:22, widened per case
BASE = dict(vocab_size=256, hidden_dim=512, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_dim=768, max_seq_len=64,
            dtype="bfloat16")


def _setup(hq, hkv, B, S, seed=1):
    """A prefilled INT8 cache of ragged left-padded prompts (JAX per-op
    path), the next token, and the same state carried into the port."""
    cfg = dict(BASE, num_heads=hq, num_kv_heads=hkv, hidden_dim=128 * hq)
    jcfg, tcfg = jcfg_mod.ModelConfig(**cfg), tcfg_mod.ModelConfig(**cfg)
    jparams = quantize_params_int8(init_params(jax.random.PRNGKey(seed),
                                               jcfg))
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 13, B)
    prompts = [list(rng.integers(1, 256, n)) for n in lens]
    ids, jlens = jgen.pad_and_stack(prompts, bucket=12)
    cache = JKVCache.create(jcfg, B, S, dtype=jnp.int8)
    logits, kv, vfrom = jgen._prefill(jparams, jcfg, ids, jlens,
                                      cache.as_slice())
    tok = np.asarray(jnp.argmax(logits, -1), np.int64)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=params_from_jax(to_numpy(jparams), device="cpu"),
                kv=kv,
                lens=np.array(jlens), vfrom=np.array(vfrom), tok=tok,
                P=ids.shape[1])


def _port_kv(kv):
    """The JAX KVSlice's caches as fresh port tensors."""
    return [torch.from_numpy(np.array(a)) for a in (kv.k.q, kv.k.s, kv.v.q,
                                                     kv.v.s)]


def _step_inputs(st, pos):
    cos_t, sin_t = j_rope(st["jcfg"].head_dim, st["jcfg"].max_seq_len,
                          st["jcfg"].rope_theta)
    return np.asarray(cos_t)[pos], np.asarray(sin_t)[pos]


def _row_rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float((np.linalg.norm(a - b, axis=-1)
                  / np.linalg.norm(b, axis=-1)).max())


def _assert_codes(jq, tq, js, ts, what):
    """Layer 0 sees the same inputs on both sides: int8 codes bit-equal,
    scales to rtol 1e-6. Deeper layers see the f32 residual stream after
    differently ordered f32 sums: codes within one level on > 99%."""
    jq, tq = np.asarray(jq, np.int32), t2n(tq).astype(np.int32)
    np.testing.assert_array_equal(tq[0], jq[0], err_msg=what)
    np.testing.assert_allclose(t2n(ts)[0], np.asarray(js)[0], rtol=1e-6,
                               err_msg=what)
    assert (np.abs(tq - jq) <= 1).mean() > 0.99, what


@pytest.mark.parametrize("hq,hkv,B,S", [(4, 2, 8, 32), (4, 4, 8, 32),
                                        (8, 1, 8, 32), (4, 2, 24, 32)])
def test_fused_step_matches_pallas(hq, hkv, B, S):
    st = _setup(hq, hkv, B, S)
    P, kv, blocks = st["P"], st["kv"], st["jparams"]["blocks"]
    pos = st["lens"]
    cos_g, sin_g = _step_inputs(st, pos)
    x = st["jparams"]["embed"][st["tok"]].astype(jnp.bfloat16)
    qslot = np.full((B,), P, np.int32)
    want = j_fused(blocks, x, kv.k.q, kv.k.s, kv.v.q, kv.v.s,
                   q_slot=jnp.asarray(qslot), valid_from=jnp.asarray(
                       st["vfrom"]), rope_cos_g=jnp.asarray(cos_g),
                   rope_sin_g=jnp.asarray(sin_g), cfg=st["jcfg"],
                   interpret=True)

    tx = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    targs = (torch.from_numpy(qslot), torch.from_numpy(st["vfrom"]),
             torch.from_numpy(cos_g), torch.from_numpy(sin_g), st["tcfg"])
    got = t_fd.fused_decode_step(st["tparams"]["blocks"], tx, *_port_kv(kv),
                                 *targs)
    # the f32 residual stream after 2 layers of differently ordered sums
    assert _row_rel(t2n(got[0]), want[0]) < 1e-2
    _assert_codes(want[1], got[1], want[2], got[2], "k")
    _assert_codes(want[3], got[3], want[4], got[4], "v")

    # the in-place write equals the returned new K/V scattered at the slot
    kq, ks, vq, vs = _port_kv(kv)
    x_w, *cache = t_fd.fused_decode_step(st["tparams"]["blocks"], tx, kq, ks,
                                         vq, vs, *targs, slot=P,
                                         write_cache=True)
    torch.testing.assert_close(x_w, got[0], rtol=0, atol=0)
    ref_k = ttf._scatter_new_kv(ttf.QuantKV(*_port_kv(kv)[:2]), got[1],
                                got[2], P)
    ref_v = ttf._scatter_new_kv(ttf.QuantKV(*_port_kv(kv)[2:]), got[3],
                                got[4], P)
    for a, b in zip(cache, (ref_k.q, ref_k.s, ref_v.q, ref_v.s)):
        assert torch.equal(a, b)

    # per-request scatter: bit-equal to the JAX package's
    start = np.arange(B, dtype=np.int32) % 5 + P - 4
    jk = j_scatter(kv.k, want[1], want[2], jnp.asarray(start))
    tk = ttf._scatter_new_kv(
        ttf.QuantKV(*_port_kv(kv)[:2]),
        torch.from_numpy(np.asarray(want[1])),
        torch.from_numpy(np.asarray(want[2])), torch.from_numpy(start))
    np.testing.assert_array_equal(t2n(tk.q), np.asarray(jk.q))
    np.testing.assert_array_equal(t2n(tk.s), np.asarray(jk.s))
    assert t_fd.launches == 0  # the CPU path launches no kernel


def test_decode_slice_matches_pallas_step_by_step():
    """Four teacher-forced steps: JAX fused_decode_step (interpret, in-place
    cache write) against the port's fused branch of forward on the CPU."""
    B, S, steps = 8, 32, 4
    st = _setup(4, 2, B, S, seed=2)
    P, kv, tcfg = st["P"], st["kv"], st["tcfg"]
    jparams, blocks = st["jparams"], st["jparams"]["blocks"]
    rng = np.random.default_rng(3)
    toks = [st["tok"]] + [rng.integers(1, 256, B) for _ in range(steps - 1)]
    jk, jv = kv.k, kv.v
    tk, tv = (ttf.QuantKV(*_port_kv(kv)[:2]), ttf.QuantKV(*_port_kv(kv)[2:]))
    tvfrom = torch.from_numpy(st["vfrom"])
    cos, sin = rope_frequencies(tcfg.head_dim, tcfg.max_seq_len,
                                tcfg.rope_theta)
    for i, tok in enumerate(toks):
        slot, pos = P + i, st["lens"] + i
        cos_g, sin_g = _step_inputs(st, pos)
        x = jparams["embed"][tok].astype(jnp.bfloat16)
        jx, jkq, jks, jvq, jvs = j_fused(
            blocks, x, jk.q, jk.s, jv.q, jv.s,
            q_slot=jnp.full((B,), slot, jnp.int32),
            valid_from=jnp.asarray(st["vfrom"]), rope_cos_g=jnp.asarray(cos_g),
            rope_sin_g=jnp.asarray(sin_g), cfg=st["jcfg"],
            slot=jnp.int32(slot), write_cache=True, interpret=True)
        jk, jv = type(jk)(jkq, jks), type(jv)(jvq, jvs)

        tx = ttf.embed_lookup(st["tparams"], torch.from_numpy(tok)[:, None],
                              tcfg)
        tx, tkv = ttf._fused_decode_forward(
            st["tparams"], tx, tcfg, ttf.KVSlice(tk, tv, slot),
            positions=torch.from_numpy(pos)[:, None],
            slots=torch.full((B, 1), slot, dtype=torch.int32),
            valid_from=tvfrom, rope_cos=cos, rope_sin=sin)
        assert tkv.start == slot + 1
        assert _row_rel(t2n(tx[:, 0]), jx) < 1e-2, i
        # every slot written so far, every layer: the prompt slots are the
        # same bytes; each step's new codes differ by at most one level where
        # the layers' f32 sums round apart
        for t, j in ((tk.q, jk.q), (tv.q, jv.q)):
            d = np.abs(t2n(t).astype(np.int32) - np.asarray(j, np.int32))
            assert d.max() <= 1 and (d == 0).mean() > 0.99, i
        for t, j in ((tk.s, jk.s), (tv.s, jv.s)):
            np.testing.assert_allclose(t2n(t), np.asarray(j), rtol=2e-2)
    assert t_fd.launches == 0


def test_gate_and_w8a8_on_cpu_take_the_per_op_path():
    """The mirrored gate passes the default config; on the CPU forward keeps
    the per-op path (as the JAX CPU backend does), W8A8 included."""
    from physics_llm_inference_tpu_torch.models.quant import init_params_int8
    from physics_llm_inference_tpu_torch.runtime.kv_cache import KVCache

    cfg = tcfg_mod.ModelConfig(**dict(BASE, act_quant="int8"))
    params = init_params_int8(torch.Generator().manual_seed(0), cfg)
    cache = KVCache.create(cfg, 8, 32, dtype=torch.int8)
    assert ttf._fused_decode_ok(params, cfg, 8, cache.as_slice())
    big = KVCache.create(dataclasses.replace(cfg, num_layers=1), 8, 8200,
                         dtype=torch.int8)
    assert not ttf._fused_decode_ok(params, cfg, 8, big.as_slice())
    tok, kv = ttf.forward(params, torch.ones((8, 1), dtype=torch.int64), cfg,
                          kv=cache.as_slice(), greedy_head=True)
    assert tok.shape == (8,) and kv.start == 1 and t_fd.launches == 0


def test_per_request_starts_scatter_like_the_uniform_write():
    """The fused branch with a (B,) tensor of starts returns the new K/V and
    scatters them; with every start equal it must leave the same hidden
    state and caches as the in-place write at a uniform slot."""
    B, S = 8, 32
    st = _setup(4, 2, B, S, seed=4)
    P, tcfg = st["P"], st["tcfg"]
    cos, sin = rope_frequencies(tcfg.head_dim, tcfg.max_seq_len,
                                tcfg.rope_theta)
    x = ttf.embed_lookup(st["tparams"], torch.from_numpy(st["tok"])[:, None],
                         tcfg)
    outs = []
    for start in (P, torch.full((B,), P, dtype=torch.int64)):
        kq, ks, vq, vs = _port_kv(st["kv"])
        kv = ttf.KVSlice(ttf.QuantKV(kq, ks), ttf.QuantKV(vq, vs), start)
        h, kv = ttf._fused_decode_forward(
            st["tparams"], x, tcfg, kv,
            positions=torch.from_numpy(st["lens"])[:, None], slots=None,
            valid_from=torch.from_numpy(st["vfrom"]), rope_cos=cos,
            rope_sin=sin)
        outs.append((h, kv.k.q, kv.k.s, kv.v.q, kv.v.s))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
