"""The port's fused whole-model decode step (kernels/fused_decode.py) against
the JAX package's Pallas kernel, run in interpret mode as the JAX package's
own tests run it on the CPU, in its three modes: W8A16 (INT8 weights), W4A16
(INT4 weights from the JAX quantizer) and W8A8 (`act_quant="int8"`). On the
CPU the port's entry point takes its plain version, which mirrors the TPU
kernel's numerics (f32 residual stream across all layers); the CUDA kernel
is held against that plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.kernels.fused_decode import \
    fused_decode_step as j_fused
from physics_llm_inference_tpu.models import config as jcfg_mod
from physics_llm_inference_tpu.models.quant import (quantize_params_int4,
                                                    quantize_params_int8)
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


MODES = ("w8a16", "w4a16", "w8a8")


def _setup(hq, hkv, B, S, seed=1, mode="w8a16"):
    """A prefilled INT8 cache of ragged left-padded prompts (JAX per-op
    path), the next token, and the same state carried into the port. `mode`
    picks the weights (INT4 for w4a16) and `act_quant` (int8 for w8a8). At
    these widths w_down (K = 768) has 3 INT4 scale groups."""
    cfg = dict(BASE, num_heads=hq, num_kv_heads=hkv, hidden_dim=128 * hq,
               act_quant="int8" if mode == "w8a8" else "none")
    jcfg, tcfg = jcfg_mod.ModelConfig(**cfg), tcfg_mod.ModelConfig(**cfg)
    quantize = quantize_params_int4 if mode == "w4a16" else \
        quantize_params_int8
    jparams = quantize(init_params(jax.random.PRNGKey(seed), jcfg))
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


SHAPES = [(4, 2, 8, 32), (4, 4, 8, 32), (8, 1, 8, 32), (4, 2, 24, 32)]


def _shape_id(shape):
    return "-".join(map(str, shape))


# the W8A16 cases keep their ids of before the other modes
@pytest.mark.parametrize("mode,hq,hkv,B,S", [
    pytest.param(mode, *shape, id=(_shape_id(shape) if mode == "w8a16"
                                   else f"{mode}-{_shape_id(shape)}"))
    for mode in MODES for shape in SHAPES])
def test_fused_step_matches_pallas(mode, hq, hkv, B, S):
    st = _setup(hq, hkv, B, S, mode=mode)
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

    # the in-place write equals the returned new K/V scattered by the JAX
    # package, at one slot (an int) and at per-request slots read from a
    # tensor: bit-equal
    start = np.arange(B, dtype=np.int32) % 5 + P - 4
    for slot, jslot in ((P, jnp.int32(P)),
                        (torch.from_numpy(start), jnp.asarray(start))):
        kq, ks, vq, vs = _port_kv(kv)
        x_w, *cache = t_fd.fused_decode_step(st["tparams"]["blocks"], tx, kq,
                                             ks, vq, vs, *targs, slot=slot,
                                             write_cache=True)
        torch.testing.assert_close(x_w, got[0], rtol=0, atol=0)
        ref_k = j_scatter(kv.k, jnp.asarray(t2n(got[1])),
                          jnp.asarray(t2n(got[2])), jslot)
        ref_v = j_scatter(kv.v, jnp.asarray(t2n(got[3])),
                          jnp.asarray(t2n(got[4])), jslot)
        for a, b in zip(cache, (ref_k.q, ref_k.s, ref_v.q, ref_v.s)):
            np.testing.assert_array_equal(t2n(a), np.asarray(b))
    # the CPU path launches no kernel
    assert t_fd.launches == t_fd.w4a16_launches == t_fd.w8a8_launches == 0


@pytest.mark.parametrize("mode", MODES)
def test_decode_slice_matches_pallas_step_by_step(mode):
    """Four teacher-forced steps: JAX fused_decode_step (interpret, in-place
    cache write) against the port's fused branch of forward on the CPU."""
    B, S, steps = 8, 32, 4
    st = _setup(4, 2, B, S, seed=2, mode=mode)
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
    assert t_fd.launches == t_fd.w4a16_launches == t_fd.w8a8_launches == 0


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


# (name, B, hidden, intermediate, q + 2 kv head columns): the 7B widths, the
# toy widths above, and ragged ones (slabs, k-tiles and m-blocks cut; at
# "ragged" INT4 w_down's scale group is 8 rows)
PLAN_SHAPES = {"7b": (64, 4096, 11008, 6144), "toy": (8, 512, 768, 1024),
               "ragged": (5, 400, 296, 560), "two_mblocks": (72, 400, 296, 560)}


def _partials(pl, m: int, slab: int) -> int:
    """The partials of row m's outputs in `slab`: one from each block that
    took a part of it (the kernel's `w8s::partials`)."""
    u = (m // 64) * pl.slabs + slab
    return pl.owner((u + 1) * pl.ktn - 1) - pl.owner(u * pl.ktn) + 1


@pytest.mark.parametrize("grid", [132, 264])
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_w8a16_plan_covers_every_unit_once_in_one_wave(mode, shape, grid):
    """The streaming kernel's plan of each GEMM phase in each K4 mode (W4A16
    over the packed bytes, 128 a slab): every (column slab, k-tile) of every
    m-block is taken exactly once, each block's share is within one k-tile
    of the mean, and no column has more partials than the workspace is
    sized for (indexed 0, 1, ... in block order). W4A16: the packed slabs
    cover both halves of N once, an output column counts the partials of
    its packed slab, and every scale group's rows are scaled once, in
    pieces cut where runs of k-tiles start or end."""
    mode = getattr(t_fd, mode.upper())
    B, D, F, QO = PLAN_SHAPES[shape]
    groups = []
    for k, n in ((D, QO), (D, D), (D, 2 * F), (F, D)):
        w4 = mode == t_fd.W4A16
        nw, slab = (n // 2, 128) if w4 else (n, 256)
        pl = t_fd._plan(B, nw, k, grid, slab) if w4 else t_fd._plan(B, n, k,
                                                                      grid)
        mblocks, slabs, ktn = -(-B // 64), -(-nw // slab), -(-k // 64)
        assert (pl.ktn, pl.slabs, pl.tiles) == (ktn, slabs,
                                                 mblocks * slabs * ktn)
        assert pl.blocks == min(grid, pl.tiles)
        seen, parts, rows = {}, {}, {}
        G = t_fd.int4_group_size(k, n)
        groups.append(G)
        for b in range(pl.blocks):
            share = 0
            for mb, sl, k0, k1, j in pl.units(b):
                assert 0 <= k0 < k1 <= ktn and 0 <= j < pl.partials
                for kt in range(k0, k1):
                    seen[mb, sl, kt] = seen.get((mb, sl, kt), 0) + 1
                parts.setdefault((mb, sl), []).append((b, j))
                share += k1 - k0
                # the consumer's group pieces: a run's rows cut at group ends
                lo, hi = k0 * 64, min(k1 * 64, k)
                for g0 in range(lo - lo % G, hi, G) if w4 else ():
                    key = (mb, sl, g0 // G)
                    piece = min(hi, g0 + G) - max(lo, g0)
                    rows[key] = rows.get(key, 0) + piece
            assert abs(share - pl.tiles / pl.blocks) < 1
        assert len(seen) == pl.tiles and set(seen.values()) == {1}
        for runs in parts.values():
            # one partial a block, numbered in block order from 0
            assert [j for _, j in runs] == list(range(len(runs)))
            assert [b for b, _ in runs] == sorted({b for b, _ in runs})
        assert max(len(r) for r in parts.values()) == pl.partials
        # the kernel gets the bound it traps on with the rest of the plan
        assert pl.args() == (pl.partials, pl.tiles, pl.blocks, ktn, slabs)
        # every output column in one slab (W4A16: that of its packed byte,
        # col mod N/2), with the partials the blocks of that slab write
        cover = [0] * n
        for sl in range(slabs):
            for c in range(sl * slab, min((sl + 1) * slab, nw)):
                for col in ((c, nw + c) if w4 else (c,)):
                    cover[col] += 1
                    assert (col % nw) // slab == sl
        assert cover == [1] * n
        for m in range(0, B, 7):
            for col in range(0, n, 4):
                sl = (col % nw) // slab
                assert _partials(pl, m, sl) == len(parts[m // 64, sl])
        if w4:
            assert len(rows) == mblocks * slabs * (k // G)
            assert set(rows.values()) == {G}
    if mode == t_fd.W4A16 and shape == "ragged":
        assert min(groups) < 16


@pytest.mark.parametrize("mode", [t_fd.W8A16, t_fd.W4A16, t_fd.W8A8])
def test_launch_scratch_is_fresh_and_sized_by_mode(mode):
    """K4's scratch is allocated anew for every launch (no launch shares
    another's, and none is kept), W8A8's int8 rows, scales and silu row
    only in that mode; the write_cache path gets its new K/V from _new_kv
    like the others."""
    B, D, F_, QH = 4, 48, 40, 64
    a = t_fd._workspace("cpu", B, D, F_, QH, 96, mode)
    b = t_fd._workspace("cpu", B, D, F_, QH, 96, mode)
    assert all(a[k].data_ptr() != b[k].data_ptr()
               for k in a if a[k] is not None)
    assert a["ws"].numel() == 96 and a["sync"].numel() == 2
    assert tuple(a["h"].shape) == (B, D) and tuple(a["ff"].shape) == (B, F_)
    w8a8 = ("a8", "asc", "ffs")
    if mode == t_fd.W8A8:
        assert a["a8"].numel() == B * 64 and a["a8"].dtype == torch.int8
        assert tuple(a["asc"].shape) == (5, B)
        assert tuple(a["ffs"].shape) == (B, F_)
    else:
        assert all(a[k] is None for k in w8a8)
    new = t_fd._new_kv(2, B, 32, 2, "cpu")
    assert [tuple(t.shape) for t in new] == [(2, B, 32), (2, B, 2),
                                             (2, B, 32), (2, B, 2)]
