"""The port's paged model steps (models/paged_transformer.py) against the JAX
package's: batched chunked prefill, the per-op decode step and the greedy
multi-step decode scan, over plain f32 pools and over the merged INT8 pools,
on the f32 toy model of tests/test_paged_engine.py. The JAX side runs its
Pallas kernels in interpret mode, as its own tests do on the CPU. Logits are
compared within tolerance, the pools outside the trash block (which every
inactive row writes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.models import ModelConfig as JConfig
from physics_llm_inference_tpu.models import init_params as j_init
from physics_llm_inference_tpu.models import paged_transformer as jpt
from physics_llm_inference_tpu.models.transformer import QuantKV as JQuantKV
from physics_llm_inference_tpu_torch.convert import (paged_kv_from_jax,
                                                     params_from_jax)
from physics_llm_inference_tpu_torch.models import paged_transformer as tpt
from physics_llm_inference_tpu_torch.models.config import \
    ModelConfig as TConfig
from torch_parity import assert_close, t2n, to_numpy

TOY = dict(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_dim=128, max_seq_len=128,
           dtype="float32")
BS, MB, NB = 8, 4, 20      # block size, table width, pool blocks (+ trash)
TRASH = NB


@pytest.fixture(scope="module")
def model():
    jcfg = JConfig(**TOY)
    jparams = j_init(jax.random.PRNGKey(1), jcfg)
    return jcfg, TConfig(**TOY), jparams, params_from_jax(to_numpy(jparams),
                                                          device="cpu")


def _pools(quantized: bool):
    L, hkv, hd = TOY["num_layers"], TOY["num_kv_heads"], 16
    if quantized:
        return JQuantKV(q=jnp.zeros((L, NB + 1, 2, BS, hkv * hd), jnp.int8),
                        s=jnp.zeros((L, NB + 1, 2, hkv, BS), jnp.float32)), None
    z = jnp.zeros((L, NB + 1, BS, hkv, hd), jnp.float32)
    return z, z


def _np(k, v):
    """Host copies of JAX pools (the jitted steps donate their inputs)."""
    if isinstance(k, JQuantKV):
        return JQuantKV(np.array(k.q), np.array(k.s)), None
    return np.array(k), np.array(v)


def _jx(k, v):
    if isinstance(k, JQuantKV):
        return JQuantKV(jnp.asarray(k.q), jnp.asarray(k.s)), None
    return jnp.asarray(k), jnp.asarray(v)


def _assert_pools(tk, tv, jk, jv, what):
    """Equal outside the trash block: f32 pools within f32 rounding, INT8
    codes bit for bit at layer 0 and within one level deeper."""
    if isinstance(jk, JQuantKV):
        tq, jq = t2n(tk.q)[:, :NB].astype(np.int32), jk.q[:, :NB].astype(
            np.int32)
        np.testing.assert_array_equal(tq[0], jq[0], err_msg=what)
        assert np.abs(tq - jq).max() <= 1, what
        assert_close(t2n(tk.s)[:, :NB], jk.s[:, :NB], "bfloat16", what)
        np.testing.assert_allclose(t2n(tk.s)[0, :NB], jk.s[0, :NB],
                                   rtol=1e-5, err_msg=what)
        return
    assert_close(t2n(tk)[:, :NB], jk[:, :NB], "float32", what)
    assert_close(t2n(tv)[:, :NB], jv[:, :NB], "float32", what)


def _prefill_both(model, quantized):
    """Two batched chunks: three prompts (one padded row pointing at the
    trash block) at start 0, then the tails of the two long ones."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(1, 100, n)) for n in (13, 6, 21)]
    tables = np.full((4, MB), TRASH, np.int32)
    tables[:3, :3] = (rng.permutation(NB)[:9]).reshape(3, 3)
    jk, jv = _pools(quantized)
    tk, tv = paged_kv_from_jax(*_np(jk, jv), device="cpu")
    logits = []
    for start, c in ((0, 8), (8, 16)):
        ids = np.zeros((4, c), np.int32)
        nval = np.zeros(4, np.int32)
        for j, p in enumerate(prompts):
            tail = p[start:start + c]
            ids[j, :len(tail)] = tail
            nval[j] = len(tail)
        starts = np.where(nval > 0, start, 0).astype(np.int32)
        jl, jk, jv = jpt.paged_prefill_chunk(
            jparams, jnp.asarray(ids), *_jx(*_np(jk, jv)),
            jnp.asarray(tables), jnp.asarray(starts), jnp.asarray(nval),
            cfg=jcfg)
        tl, tk, tv = tpt.paged_prefill_chunk_impl(
            tparams, torch.from_numpy(ids), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(starts), torch.from_numpy(nval), tcfg)
        live = nval > 0
        logits.append((t2n(tl)[live], np.asarray(jl)[live]))
    return prompts, tables, (tk, tv), _np(jk, jv), logits


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_chunks_match_jax(model, quantized):
    _, _, (tk, tv), (jk, jv), logits = _prefill_both(model, quantized)
    for i, (t, j) in enumerate(logits):
        # prefill attends the dequantized pools in f32 on both sides
        assert_close(t, j, "float32", f"chunk {i}")
    _assert_pools(tk, tv, jk, jv, "after prefill")


@pytest.mark.parametrize("quantized", [False, True])
def test_per_op_decode_step_and_scan_match_jax(model, quantized):
    jcfg, tcfg, jparams, tparams = model
    prompts, tables, (tk, tv), (jk, jv), _ = _prefill_both(model, quantized)
    lens = np.asarray([len(p) for p in prompts] + [MB * BS - 1], np.int32)
    tok = np.asarray([7, 3, 55, 0], np.int32)
    # row 3 is inactive: all-trash table, a stale length
    jl, jk2, jv2 = jpt.paged_decode_step(
        jparams, jnp.asarray(tok), *_jx(jk, jv), jnp.asarray(tables),
        jnp.asarray(lens), cfg=jcfg)
    tl, tk, tv = tpt.paged_decode_step(tparams, torch.from_numpy(tok), tk, tv,
                                       torch.from_numpy(tables),
                                       torch.from_numpy(lens), tcfg)
    # INT8 pools: K6 rounds p * v_scale to bf16 against another running max
    # than the Pallas kernel; f32 pools: f32 throughout
    assert_close(t2n(tl)[:3], np.asarray(jl)[:3],
                 "bfloat16" if quantized else "float32")
    jk, jv = _np(jk2, jv2)
    _assert_pools(tk, tv, jk, jv, "after one decode step")

    # greedy horizon-4 scan from there: the same tokens on the active rows
    nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    temps, top_ps = np.zeros(4, np.float32), np.ones(4, np.float32)
    jt, jk3, jv3 = jpt.paged_decode_scan(
        jparams, jnp.asarray(nxt), *_jx(jk, jv), jnp.asarray(tables),
        jnp.asarray(lens + 1), jax.random.PRNGKey(0), jnp.asarray(temps),
        jnp.asarray(top_ps), cfg=jcfg, horizon=4, filtered=False)
    tt, tk, tv = tpt.paged_decode_scan_impl(
        tparams, torch.from_numpy(nxt), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(lens + 1), torch.Generator().manual_seed(0),
        torch.from_numpy(temps), torch.from_numpy(top_ps), tcfg, horizon=4,
        filtered=False)
    assert tt.shape == (4, 4) and tt.dtype == torch.int32
    np.testing.assert_array_equal(t2n(tt)[:3], np.asarray(jt)[:3])
    _assert_pools(tk, tv, *_np(jk3, jv3), "after the scan")


def test_moe_and_tp_raise(model):
    """Neither an MoE nor a TP config raises in the paged step any more
    (both once did; the test keeps its name): a TP local config runs the
    paged decode step through its hooks (on one rank the identity: the
    same logits as the plain config); an MoE config runs a paged decode
    step (the routed FFN over every row, the inactive one included, with
    no valid mask) whose logits and pools equal the JAX package's."""
    _, tcfg, _, tparams = model
    from physics_llm_inference_tpu_torch.parallel.tp import tp_local_config
    from torch_dist_workers import OneRankMesh

    cfg = tp_local_config(tcfg, 1, data_axis=None,
                          mesh=OneRankMesh(model=1))
    args = (torch.full((1,), 5, dtype=torch.int32),)
    want = tpt.paged_decode_step(tparams, *args, *paged_kv_from_jax(
        *_np(*_pools(False)), device="cpu"), torch.zeros(
        (1, MB), dtype=torch.int32), torch.zeros(1, dtype=torch.int32), tcfg)
    got = tpt.paged_decode_step(tparams, *args, *paged_kv_from_jax(
        *_np(*_pools(False)), device="cpu"), torch.zeros(
        (1, MB), dtype=torch.int32), torch.zeros(1, dtype=torch.int32), cfg)
    np.testing.assert_array_equal(t2n(got[0]), t2n(want[0]))

    # capacity factor 4.0: no pair is dropped, so an f32 ulp cannot move a
    # token across an expert's capacity (tests/test_moe_serving.py)
    moe = dict(TOY, num_experts=4, expert_capacity_factor=4.0)
    jcfg, tcfg = JConfig(**moe), TConfig(**moe)
    jparams = j_init(jax.random.PRNGKey(2), jcfg)
    tparams = params_from_jax(to_numpy(jparams), device="cpu")
    rng = np.random.default_rng(3)
    tables = np.full((4, MB), TRASH, np.int32)
    tables[:3, :2] = rng.permutation(NB)[:6].reshape(3, 2)
    lens = np.asarray([3, 9, 14, MB * BS - 1], np.int32)
    tok = np.asarray([7, 3, 55, 0], np.int32)
    jk, jv = _np(*_pools(False))
    tk, tv = paged_kv_from_jax(jk, jv, device="cpu")
    jl, jk, jv = jpt.paged_decode_step(
        jparams, jnp.asarray(tok), *_jx(jk, jv), jnp.asarray(tables),
        jnp.asarray(lens), cfg=jcfg)
    tl, tk, tv = tpt.paged_decode_step(tparams, torch.from_numpy(tok), tk, tv,
                                       torch.from_numpy(tables),
                                       torch.from_numpy(lens), tcfg)
    assert_close(t2n(tl)[:3], np.asarray(jl)[:3], "float32")
    _assert_pools(tk, tv, *_np(jk, jv), "after an MoE decode step")


@pytest.mark.parametrize("quantized", [False, True])
def test_padded_prefill_chunk_routes_padding_to_trash(model, quantized,
                                                      monkeypatch):
    """One chunk whose rows are mostly padding (a padded row on the trash
    block, tokens past nvalid in blocks the requests own), run with every
    tensor-to-host read disabled: the valid rows' logits and the pools
    outside the trash block match the JAX package's (which drops the
    padding's writes), and the padding's K/V land in the trash block."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(11)
    ids = rng.integers(1, 100, (4, 16)).astype(np.int32)
    nval = np.array([3, 16, 9, 0], np.int32)
    starts = np.array([0, 8, 5, 0], np.int32)
    tables = np.full((4, MB), TRASH, np.int32)
    tables[:3, :3] = (rng.permutation(NB)[:9]).reshape(3, 3)
    jk, jv = _pools(quantized)
    tk, tv = paged_kv_from_jax(*_np(jk, jv), device="cpu")
    trash_before = (t2n(tk.q if quantized else tk)[:, TRASH]).copy()
    jl, jk, jv = jpt.paged_prefill_chunk(
        jparams, jnp.asarray(ids), *_jx(*_np(jk, jv)), jnp.asarray(tables),
        jnp.asarray(starts), jnp.asarray(nval), cfg=jcfg)

    def no_host_read(*a, **k):
        raise AssertionError("a host read inside the prefill chunk")

    for name in ("nonzero", "item", "tolist", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, no_host_read)
    tl, tk, tv = tpt.paged_prefill_chunk_impl(
        tparams, torch.from_numpy(ids), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(starts), torch.from_numpy(nval), tcfg)
    monkeypatch.undo()
    live = nval > 0
    assert_close(t2n(tl)[live], np.asarray(jl)[live], "float32", "logits")
    _assert_pools(tk, tv, *_np(jk, jv), "padded chunk")
    assert not np.array_equal(t2n(tk.q if quantized else tk)[:, TRASH],
                              trash_before)
