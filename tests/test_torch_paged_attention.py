"""The port's paged decode attention (kernels/paged_attention.py: K6 over the
merged INT8 pools, K7 over plain pools) against the JAX package's Pallas
kernels, run in interpret mode as its own tests run them on the CPU, and the
paged pool writes against the reference's scatters. On the CPU the port's
entry points take their plain twins; the CUDA kernels are held against the
same twins on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.kernels import paged_attention as jpa
from physics_llm_inference_tpu.kernels.quant import quantize_int8
from physics_llm_inference_tpu_torch.kernels import paged_attention as tpa
from torch_parity import assert_close, t2n

BS = 16  # the block size of tests/test_paged_attention.py


def _tables(rng, lens, mb, nb, decoy):
    """Scattered block ids in no particular order, never the decoy block;
    columns past a request's length point at the decoy."""
    ids = [b for b in rng.permutation(nb) if b != decoy]
    tables = np.full((len(lens), mb), decoy, np.int32)
    k = 0
    for i, n in enumerate(lens):
        used = -(-n // BS)
        tables[i, :used] = ids[k:k + used]
        k += used
    return tables


# ragged lengths: 1, an exact block boundary, one past it, the whole table
LENS = [1, 16, 17, 40, 64]


def _plain_pools(rng, L, nb, hkv, d, decoy):
    k = rng.normal(0, 1, (L, nb, BS, hkv, d)).astype(np.float32)
    v = rng.normal(0, 1, (L, nb, BS, hkv, d)).astype(np.float32)
    k[:, decoy] = 99.0            # must never be read
    v[:, decoy] = 99.0
    return k, v


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("hq,hkv,d", [
    pytest.param(4, 2, 64, id="4-2"), pytest.param(4, 4, 64, id="4-4"),
    pytest.param(8, 1, 64, id="8-1"), pytest.param(16, 2, 64, id="16-2"),
    pytest.param(16, 2, 128, id="16-2-d128"),
    pytest.param(8, 1, 120, id="8-1-d120")])   # K7 takes d % 8
def test_paged_attention_twin_matches_pallas(stacked, hq, hkv, d):
    rng = np.random.default_rng(hq * 10 + hkv)
    L, nb, mb, decoy = 2, 24, 4, 5
    k, v = _plain_pools(rng, L, nb, hkv, d, decoy)
    q = rng.normal(0, 1, (len(LENS), hq, d)).astype(np.float32)
    tables = _tables(rng, LENS, mb, nb, decoy)
    lens = np.asarray(LENS, np.int32)
    for l in range(L):
        if stacked:
            jargs, targs = (k, v), (torch.from_numpy(k), torch.from_numpy(v))
            kw = dict(layer=l)
        else:
            jargs = (k[l], v[l])
            targs = (torch.from_numpy(k[l]), torch.from_numpy(v[l]))
            kw = {}
        want = jpa.paged_decode_attention(
            jnp.asarray(q), *(jnp.asarray(a) for a in jargs),
            jnp.asarray(tables), jnp.asarray(lens),
            **({"layer": jnp.int32(l)} if stacked else {}), interpret=True)
        got = tpa.paged_decode_attention(torch.from_numpy(q), *targs,
                                         torch.from_numpy(tables),
                                         torch.from_numpy(lens), **kw)
        # f32 throughout on both sides: only the order of f32 sums differs
        assert_close(t2n(got), want, "float32", f"layer {l}")
        assert float(got.abs().max()) < 50        # no decoy value leaked
    assert tpa.paged_launches == 0


def _int8_pools(rng, L, nb, hkv, d, decoy):
    """Merged pools (L, NB, 2, BS, Hkv·d) int8 / (L, NB, 2, Hkv, BS) f32
    from quantized normal K and V; the decoy block holds extreme codes."""
    kp = rng.normal(0, 1, (L, nb, BS, hkv, d)).astype(np.float32)
    vp = rng.normal(0, 1, (L, nb, BS, hkv, d)).astype(np.float32)
    kq, ks = quantize_int8(jnp.asarray(kp), axis=-1)
    vq, vs = quantize_int8(jnp.asarray(vp), axis=-1)
    kv = np.stack([np.asarray(kq).reshape(L, nb, BS, hkv * d),
                   np.asarray(vq).reshape(L, nb, BS, hkv * d)], axis=2)
    kvs = np.stack([np.asarray(ks)[..., 0].transpose(0, 1, 3, 2),
                    np.asarray(vs)[..., 0].transpose(0, 1, 3, 2)], axis=2)
    kv[:, decoy] = 127
    kvs[:, decoy] = 1e3
    return kv, kvs


@pytest.mark.parametrize("hq,hkv,d", [
    pytest.param(4, 2, 64, id="4-2"), pytest.param(8, 1, 64, id="8-1"),
    pytest.param(16, 2, 64, id="16-2"),
    pytest.param(16, 2, 128, id="16-2-d128"),
    pytest.param(4, 4, 128, id="4-4-d128")])
@pytest.mark.parametrize("unstacked", [False, True])
def test_int8_paged_attention_twin_matches_pallas(hq, hkv, d, unstacked):
    rng = np.random.default_rng(hq + 3 * hkv)
    L, nb, mb, decoy = 2, 24, 4, 7
    kv, kvs = _int8_pools(rng, L, nb, hkv, d, decoy)
    q = rng.normal(0, 1, (len(LENS), hq, d)).astype(np.float32)
    tables = _tables(rng, LENS, mb, nb, decoy)
    lens = np.asarray(LENS, np.int32)
    for l in range(L):
        if unstacked:
            jkv, jkvs, kw = kv[l], kvs[l], {}
        else:
            jkv, jkvs, kw = kv, kvs, dict(layer=l)
        want = jpa.int8_paged_decode_attention(
            jnp.asarray(q), jnp.asarray(jkv), jnp.asarray(jkvs),
            jnp.asarray(tables), jnp.asarray(lens),
            **({"layer": jnp.int32(l)} if kw else {}), interpret=True)
        got = tpa.int8_paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(jkv), torch.from_numpy(jkvs),
            torch.from_numpy(tables), torch.from_numpy(lens), **kw)
        # both round p * v_scale to bf16, the Pallas kernel against its
        # block-by-block running max, the twin against the row max: bf16 ulps
        assert_close(t2n(got), want, "bfloat16", f"layer {l}")
        assert float(got.abs().max()) < 50
    assert tpa.int8_paged_launches == 0


def test_rows_past_the_table_and_empty_rows():
    """A context longer than the table is cut at MB·BS (JAX reads the same
    keys); a row with no key gives 0, as the Pallas kernel's l = 0 path."""
    rng = np.random.default_rng(11)
    L, nb, hq, hkv, d, mb, decoy = 1, 12, 4, 2, 64, 2, 0
    kv, kvs = _int8_pools(rng, L, nb, hkv, d, decoy)
    k, v = _plain_pools(rng, L, nb, hkv, d, decoy)
    q = rng.normal(0, 1, (3, hq, d)).astype(np.float32)
    tables = np.asarray([[3, 4], [5, 6], [7, 8]], np.int32)
    long_lens = np.asarray([mb * BS, mb * BS + 5, 3], np.int32)
    cut = np.minimum(long_lens, mb * BS)
    for fn, pools in ((tpa.int8_paged_decode_attention, (kv, kvs)),
                      (tpa.paged_decode_attention, (k, v))):
        args = [torch.from_numpy(p[0]) for p in pools]
        a = fn(torch.from_numpy(q), *args, torch.from_numpy(tables),
               torch.from_numpy(long_lens))
        b = fn(torch.from_numpy(q), *args, torch.from_numpy(tables),
               torch.from_numpy(cut))
        assert torch.equal(a, b)
        z = fn(torch.from_numpy(q), *args, torch.from_numpy(tables),
               torch.zeros(3, dtype=torch.int32))
        assert not z.any()
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k[0]), jnp.asarray(v[0]),
        jnp.asarray(tables), jnp.asarray(long_lens), interpret=True)
    got = tpa.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k[0]), torch.from_numpy(v[0]),
        torch.from_numpy(tables), torch.from_numpy(long_lens))
    assert_close(t2n(got), want, "float32")


def test_paged_write_matches_reference():
    """The cases of tests/test_paged_attention.py::TestPagedWrites, plus a
    random scatter held against the reference's."""
    hkv, d = 2, 64
    rng = np.random.default_rng(2)
    kp = rng.normal(size=(8, BS, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(8, BS, hkv, d)).astype(np.float32)
    k_new = rng.normal(size=(3, hkv, d)).astype(np.float32)
    v_new = rng.normal(size=(3, hkv, d)).astype(np.float32)
    blk, off = np.asarray([3, 5, 0]), np.asarray([0, 7, 15])
    jk, jv = jpa.paged_write(jnp.asarray(kp), jnp.asarray(vp),
                             jnp.asarray(k_new), jnp.asarray(v_new),
                             jnp.asarray(blk), jnp.asarray(off))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = tpa.paged_write(tk, tv, torch.from_numpy(k_new),
                          torch.from_numpy(v_new), torch.from_numpy(blk),
                          torch.from_numpy(off))
    assert out[0] is tk and out[1] is tv            # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    # reference test: ones into block 3 slot 0, twos into block 5 slot 7
    kz = torch.zeros((8, BS, hkv, d))
    vz = torch.zeros_like(kz)
    tpa.paged_write(kz, vz, torch.ones((2, hkv, d)),
                    torch.full((2, hkv, d), 2.0), torch.tensor([3, 5]),
                    torch.tensor([0, 7]))
    assert float(kz[3, 0, 0, 0]) == 1.0 and float(vz[5, 7, 1, 0]) == 2.0
    assert float(kz[3, 1, 0, 0]) == 0.0


@pytest.mark.parametrize("length", [BS + 3, 2 * BS, 1])
def test_paged_write_prefill_drops_padding(length):
    hkv, d = 2, 64
    rng = np.random.default_rng(length)
    seq = rng.normal(size=(2 * BS, hkv, d)).astype(np.float32)
    table = np.asarray([1, 2, 0, 0], np.int32)
    kp = np.zeros((4, BS, hkv, d), np.float32)
    jk, jv = jpa.paged_write_prefill(jnp.asarray(kp), jnp.asarray(kp),
                                     jnp.asarray(seq), jnp.asarray(-seq),
                                     jnp.asarray(table), length=length)
    tk, tv = torch.zeros((4, BS, hkv, d)), torch.zeros((4, BS, hkv, d))
    tpa.paged_write_prefill(tk, tv, torch.from_numpy(seq),
                            torch.from_numpy(-seq), torch.from_numpy(table),
                            length)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not tk[0].any()                           # table tail untouched


def test_write_position_clamps_the_column():
    tables = torch.tensor([[4, 5, 6], [7, 8, 9]], dtype=torch.int32)
    blk, off = tpa.write_position(tables, torch.tensor([17, 48]), 16)
    # 48 = MB·BS: the clamped column 2, offset 0, inside the row's own blocks
    assert blk.tolist() == [5, 9] and off.tolist() == [1, 0]
    want = jnp.asarray(tables.numpy())[jnp.arange(2),
                                       jnp.asarray([17, 48]) // 16]
    assert blk.tolist() == np.asarray(want).tolist()
