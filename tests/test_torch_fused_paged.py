"""The port's fused paged decode step (K8, kernels/fused_decode.py
`fused_paged_decode_step`) against the JAX package's Pallas kernel, run in
interpret mode as its own tests run it on the CPU, at the geometry of
tests/test_fused_decode.py `_paged_setup` (B = 8, BS = 8, MB = 4, hidden
256, 2 layers, bf16). On the CPU the port's entry point takes its plain twin
(blocks gathered into a slot view, then `fused_decode_step_plain`); the CUDA
kernel is held against that twin on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.kernels.fused_decode import \
    fused_paged_decode_step as j_fused_paged
from physics_llm_inference_tpu.models import ModelConfig as JConfig
from physics_llm_inference_tpu.models.quant import init_params_int8
from physics_llm_inference_tpu.ops.rope import rope_frequencies
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.kernels import fused_decode as t_fd
from physics_llm_inference_tpu_torch.models import paged_transformer as tpt
from physics_llm_inference_tpu_torch.models.config import \
    ModelConfig as TConfig
from physics_llm_inference_tpu_torch.models.transformer import QuantKV
from physics_llm_inference_tpu_torch.serve.paged_engine import \
    PagedEngineConfig
from torch_parity import t2n, to_numpy

CFG = dict(vocab_size=64, hidden_dim=256, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_dim=512, max_seq_len=64,
           dtype="bfloat16")
B, BS, MB = 8, 8, 4


def _setup(seed=0):
    """Merged pools with every request's blocks scattered over the pool
    (blocks 0, 1 and NB - 1 unused), ragged lengths, random x."""
    jcfg = JConfig(**CFG)
    L, flat = jcfg.num_layers, jcfg.num_kv_heads * jcfg.head_dim
    jparams = init_params_int8(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, BS * MB - 1, (B,)).astype(np.int32)
    lens[:2] = (BS, 2 * BS - 1)                 # a block boundary, its edge
    nb = B * MB + 3
    tables = (rng.permutation(B * MB) + 2).reshape(B, MB).astype(np.int32)
    kv = rng.integers(-127, 128, (L, nb, 2, BS, flat)).astype(np.int8)
    kvs = (np.abs(rng.normal(size=(L, nb, 2, jcfg.num_kv_heads, BS)))
           * 0.05 + 0.01).astype(np.float32)
    x0 = rng.normal(size=(B, jcfg.hidden_dim)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=TConfig(**CFG), jparams=jparams,
                tblocks=params_from_jax(to_numpy(jparams),
                                        device="cpu")["blocks"],
                lens=lens, tables=tables, kv=kv, kvs=kvs, x0=x0)


def _rope(st, lens):
    cos, sin = rope_frequencies(st["jcfg"].head_dim, st["jcfg"].max_seq_len,
                                st["jcfg"].rope_theta)
    return np.asarray(cos)[lens], np.asarray(sin)[lens]


def _port(st, lens=None, inplace=False):
    lens = st["lens"] if lens is None else lens
    cos, sin = _rope(st, lens)
    kv, kvs = torch.from_numpy(st["kv"].copy()), torch.from_numpy(
        st["kvs"].copy())
    out = t_fd.fused_paged_decode_step(
        st["tblocks"], torch.from_numpy(st["x0"]).bfloat16(), kv, kvs,
        torch.from_numpy(st["tables"]), torch.from_numpy(lens),
        torch.from_numpy(cos), torch.from_numpy(sin), st["tcfg"],
        inplace=inplace)
    return out, kv, kvs


def _row_rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float((np.linalg.norm(a - b, axis=-1)
                  / np.linalg.norm(b, axis=-1)).max())


def _assert_codes(jq, tq, js, ts, what):
    """Layer 0 sees the same inputs on both sides: codes bit-equal, scales
    to rtol 1e-6. Deeper layers see the f32 residual stream after
    differently ordered f32 sums: codes within one level on > 99%."""
    jq, tq = np.asarray(jq, np.int32), np.asarray(tq, np.int32)
    np.testing.assert_array_equal(tq[0], jq[0], err_msg=what)
    np.testing.assert_allclose(np.asarray(ts)[0], np.asarray(js)[0],
                               rtol=1e-6, err_msg=what)
    d = np.abs(tq - jq)
    assert d.max() <= 1 and (d == 0).mean() > 0.99, what


def test_fused_paged_step_matches_pallas_both_modes():
    st = _setup()
    cos, sin = _rope(st, st["lens"])
    # one interpret-mode call: inplace=True returns the new K/V and the
    # written pools
    want = j_fused_paged(
        st["jparams"]["blocks"], jnp.asarray(st["x0"], jnp.bfloat16),
        jnp.asarray(st["kv"]), jnp.asarray(st["kvs"]),
        jnp.asarray(st["tables"]), jnp.asarray(st["lens"]), jnp.asarray(cos),
        jnp.asarray(sin), cfg=st["jcfg"], interpret=True, tn_target=128,
        inplace=True, ring_slots=1)
    got, kv0, kvs0 = _port(st)
    assert len(got) == 5
    # the f32 residual stream after 2 layers of differently ordered sums
    assert _row_rel(t2n(got[0]), want[0]) < 1e-2
    _assert_codes(want[1], t2n(got[1]), want[2], t2n(got[2]), "k")
    _assert_codes(want[3], t2n(got[3]), want[4], t2n(got[4]), "v")
    assert torch.equal(kv0, torch.from_numpy(st["kv"]))      # not written

    got_i, kv, kvs = _port(st, inplace=True)
    assert len(got_i) == 7 and got_i[5] is kv and got_i[6] is kvs
    assert torch.equal(got_i[0], got[0])
    for a, b in zip(got_i[1:5], got[1:]):
        assert torch.equal(a, b)
    jkv, jkvs = np.asarray(want[5]), np.asarray(want[6])
    # layer 0 of the pools bit for bit; layer 1 within one level at the
    # written slots and equal everywhere else
    np.testing.assert_array_equal(kv.numpy()[0], jkv[0])
    np.testing.assert_allclose(kvs.numpy()[0], jkvs[0], rtol=1e-6)
    d = np.abs(kv.numpy().astype(np.int32) - jkv.astype(np.int32))
    assert d.max() <= 1
    np.testing.assert_allclose(kvs.numpy(), jkvs, rtol=2e-2)
    assert t_fd.paged_launches == 0


def test_scatter_layout():
    """The in-place writes land each request's new K/V exactly where the
    per-op path writes them: pools[:, tables[b, len // BS], page, len % BS]
    (the reference's test_paged_step_impl_scatter_layout), and equal the
    JAX package's advanced-index scatter of the same codes."""
    st = _setup(seed=1)
    (x, k_new, ks, v_new, vs, kv, kvs), _, _ = _port(st, inplace=True)
    lens = st["lens"]
    blk = st["tables"][np.arange(B), lens // BS]
    off = lens % BS
    for r in range(B):
        assert torch.equal(kv[:, blk[r], 0, off[r]], k_new[:, r])
        assert torch.equal(kv[:, blk[r], 1, off[r]], v_new[:, r])
        assert torch.equal(kvs[:, blk[r], 0, :, off[r]], ks[:, r])
        assert torch.equal(kvs[:, blk[r], 1, :, off[r]], vs[:, r])
    q2 = (jnp.asarray(st["kv"]).at[:, blk, 0, off].set(t2n(k_new))
          .at[:, blk, 1, off].set(t2n(v_new)))
    s2 = (jnp.asarray(st["kvs"]).at[:, blk, 0, :, off]
          .set(t2n(ks).transpose(1, 0, 2))
          .at[:, blk, 1, :, off].set(t2n(vs).transpose(1, 0, 2)))
    np.testing.assert_array_equal(kv.numpy(), np.asarray(q2))
    np.testing.assert_array_equal(kvs.numpy(), np.asarray(s2))


def test_stale_length_writes_inside_its_own_row():
    """A retired row's length can pass the table inside a decode horizon: at
    length MB·BS (and past it) the write lands in the row's own last block,
    at len % BS, as JAX's clamped gather puts it; no other block changes
    but the other rows' own write slots."""
    st = _setup(seed=2)
    for stale in (MB * BS, MB * BS + 3):
        lens = st["lens"].copy()
        lens[3] = stale
        _, kv, kvs = _port(st, lens=lens, inplace=True)
        changed = np.argwhere((kv.numpy() != st["kv"]).any(axis=(2, 4)))
        cols = np.minimum(lens // BS, MB - 1)
        allowed = {(int(st["tables"][r, cols[r]]), int(lens[r] % BS))
                   for r in range(B)}
        assert {(int(b), int(o)) for _, b, o in changed} <= allowed
        assert (int(st["tables"][3, MB - 1]), stale % BS) in \
            {(int(b), int(o)) for _, b, o in changed}
        scales = np.argwhere((kvs.numpy() != st["kvs"]).any(axis=(2, 3)))
        assert {(int(b), int(o)) for _, b, o in scales} <= allowed


def test_gate():
    """False on the CPU, as on the JAX CPU backend; the default 7B engine
    geometry passes the port's gate, as it passes the reference's."""
    cfg7 = TConfig(vocab_size=32000, hidden_dim=4096, num_layers=32,
                   num_heads=32, num_kv_heads=8, intermediate_dim=11008,
                   max_seq_len=1024)
    pc = PagedEngineConfig()
    assert t_fd.fused_paged_decode_ok(cfg7, pc.max_batch,
                                      pc.max_blocks_per_request,
                                      pc.block_size, NB=pc.num_blocks + 1)
    fused = PagedEngineConfig.for_fused(max_batch=64, max_seq_len=512)
    assert t_fd.fused_paged_decode_ok(cfg7, 64, fused.max_blocks_per_request,
                                      fused.block_size)
    assert not t_fd.fused_paged_decode_ok(cfg7, 64, 64, 16)      # BS % 128
    assert not t_fd.fused_paged_decode_ok(cfg7, 60, 2, 512)      # B % 8
    # every condition passes but the tensors are on the CPU
    st = _setup()
    cfg = TConfig(**dict(CFG, hidden_dim=256, num_heads=2, num_kv_heads=1))
    assert cfg.head_dim == 128 and t_fd.fused_paged_decode_ok(cfg, 8, 2, 128)
    pools = QuantKV(torch.zeros((2, 17, 2, 128, 128), dtype=torch.int8),
                    torch.zeros((2, 17, 2, 1, 128)))
    assert not tpt._paged_fused_ok({"blocks": st["tblocks"]}, cfg, 8, pools,
                                   torch.zeros((8, 2), dtype=torch.int32))


@pytest.mark.parametrize("kw", [dict(act_quant="int8"), dict(num_experts=4)])
def test_gate_keeps_the_reference_conditions(kw):
    cfg = TConfig(vocab_size=64, hidden_dim=256, num_layers=1, num_heads=2,
                  num_kv_heads=1, intermediate_dim=256, **kw)
    assert not t_fd.fused_paged_decode_ok(cfg, 8, 2, 128)
