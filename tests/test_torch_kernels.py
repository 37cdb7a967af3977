"""Each ported kernel's plain version against the JAX package's Pallas kernel,
run in interpret mode as the JAX package's own tests run it on the CPU, and
the wrappers' CPU contract. The CUDA kernels themselves are held against
these plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.kernels.int8_kv_attention import \
    int8_kv_decode_attention as j_attn
from physics_llm_inference_tpu.kernels.int8_matmul import int8_matmul as j_mm
from physics_llm_inference_tpu.kernels.lmhead import lmhead_greedy as j_head
from physics_llm_inference_tpu.kernels.lmhead import \
    lmhead_greedy_ok as j_head_ok
from physics_llm_inference_tpu_torch.kernels import int8_kv_attention as t_attn
from physics_llm_inference_tpu_torch.kernels import int8_matmul as t_mm
from physics_llm_inference_tpu_torch.kernels import lmhead as t_head
from physics_llm_inference_tpu_torch.kernels import w8a16_stream as t_ws
from torch_parity import t2n


def _mm_inputs(seed=0, L=3, M=16, K=256, N=384):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    wq = rng.integers(-127, 128, (L, K, N)).astype(np.int8)
    s = rng.uniform(0.001, 0.01, (L, 1, N)).astype(np.float32)
    return x, wq, s


def test_int8_matmul_2d_matches_pallas():
    x, wq, s = _mm_inputs()
    want = j_mm(jnp.asarray(x), jnp.asarray(wq[0]), jnp.asarray(s[0]),
                block_m=16, block_n=128, block_k=128, interpret=True)
    got = t_mm.int8_matmul(torch.from_numpy(x), torch.from_numpy(wq[0]),
                           torch.from_numpy(s[0]))
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("layer", [0, 2])
def test_int8_matmul_stacked_matches_pallas(layer):
    x, wq, s = _mm_inputs(1)
    want = j_mm(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s),
                block_m=16, block_n=128, block_k=128, interpret=True,
                layer=jnp.int32(layer))
    got = t_mm.int8_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                           torch.from_numpy(s), layer=layer)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


# (valid_from, q_slot) rows: live ranges of 1, 15, 16, 17 and 33 keys, most
# starting off the 16-key grid (the CUDA loop's warp split and 16-key steps)
RAGGED = [(20, 20), (3, 17), (21, 36), (7, 23), (30, 62)]


def _attn_inputs(seed=2, L=2, B=4, S=64, hq=8, hkv=2, d=64, ranges=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, hq, d)).astype(np.float32)
    kq = rng.integers(-127, 128, (L, B, S, hkv * d)).astype(np.int8)
    vq = rng.integers(-127, 128, (L, B, S, hkv * d)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (L, B, hkv, S)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (L, B, hkv, S)).astype(np.float32)
    if ranges is None:
        qslot = np.array([63, 40, 7, 20], np.int32)[:B]
        vfrom = np.array([0, 5, 2, 20], np.int32)[:B]
    else:
        vfrom, qslot = np.array(ranges, np.int32).T.copy()
    return q, kq, ks, vq, vs, qslot, vfrom


# shape: (Hq, Hkv, head_dim) over the RAGGED rows; None: the first inputs
@pytest.mark.parametrize("layer,shape", [
    pytest.param(0, None, id="0"), pytest.param(1, None, id="1"),
    pytest.param(1, (8, 1, 64), id="ragged-group8-d64"),
    pytest.param(0, (16, 2, 128), id="ragged-group8-d128"),
    pytest.param(1, (4, 4, 128), id="ragged-group1-d128"),
    pytest.param(0, (4, 4, 64), id="ragged-group1-d64"),
    pytest.param(1, (8, 2, 64), id="ragged-group4-d64")])
def test_int8_kv_attention_matches_pallas(layer, shape):
    if shape is None:
        q, kq, ks, vq, vs, qslot, vfrom = _attn_inputs()
    else:
        hq, hkv, d = shape
        q, kq, ks, vq, vs, qslot, vfrom = _attn_inputs(
            4, B=len(RAGGED), hq=hq, hkv=hkv, d=d, ranges=RAGGED)
    want = j_attn(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks),
                  jnp.asarray(vq), jnp.asarray(vs), q_slot=jnp.asarray(qslot),
                  valid_from=jnp.asarray(vfrom), layer=jnp.int32(layer),
                  interpret=True)
    t = [torch.from_numpy(a) for a in (q, kq, ks, vq, vs, qslot, vfrom)]
    got = t_attn.int8_kv_decode_attention(*t[:5], q_slot=t[5],
                                          valid_from=t[6], layer=layer)
    # the TPU kernel feeds q, K and p*v_scale to the MXU in bf16 (relative
    # 2^-8 each) while the plain version stays f32: outputs are O(1)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=2e-2)


def test_int8_kv_attention_unstacked_equals_stacked_layer():
    q, kq, ks, vq, vs, qslot, vfrom = _attn_inputs(3)
    t = [torch.from_numpy(a) for a in (q, kq, ks, vq, vs, qslot, vfrom)]
    stacked = t_attn.int8_kv_decode_attention(*t[:5], q_slot=t[5],
                                              valid_from=t[6], layer=1)
    sliced = t_attn.int8_kv_decode_attention(t[0], t[1][1], t[2][1], t[3][1],
                                             t[4][1], q_slot=t[5],
                                             valid_from=t[6])
    torch.testing.assert_close(stacked, sliced, rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_lmhead_greedy_matches_pallas(seed):
    # D = V = 512: lmhead_greedy_ok needs D % 512 == 0 here (TK = 512)
    B, D, V = 16, 512, 512
    assert j_head_ok(B, D, V) and t_head.lmhead_greedy_ok(B, D, V)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, D)).astype(np.float32)
    nw = rng.normal(1, 0.1, (D,)).astype(np.float32)
    lq = rng.integers(-127, 128, (D, V)).astype(np.int8)
    ls = rng.uniform(0.001, 0.01, (1, V)).astype(np.float32)
    want = j_head(jnp.asarray(x, jnp.bfloat16), jnp.asarray(nw, jnp.bfloat16),
                  jnp.asarray(lq), jnp.asarray(ls), eps=1e-6, interpret=True)
    got = t_head.lmhead_greedy(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(nw).bfloat16(),
                               torch.from_numpy(lq), torch.from_numpy(ls),
                               eps=1e-6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


def test_lmhead_first_max_after_bf16_round():
    # two logits that differ in f32 but round to the same bf16: the first wins
    D, V = 4, 8
    x = torch.ones((1, D))
    lq = torch.zeros((D, V), dtype=torch.int8)
    lq[:, 2] = 100
    lq[:, 5] = 100
    ls = torch.full((V,), 0.01)
    ls[5] = 0.01 * (1 + 2 ** -10)
    tok = t_head.lmhead_greedy_plain(x, torch.ones(D), lq, ls)
    assert tok.tolist() == [2]


@pytest.mark.parametrize("gate_args", [(64, 4096, 32000), (3, 512, 512),
                                       (8, 256, 512), (8, 512, 500)])
def test_lmhead_gate_mirrors_jax(gate_args):
    assert t_head.lmhead_greedy_ok(*gate_args) == j_head_ok(*gate_args)


def test_cpu_tensors_take_plain_versions_without_launching():
    before = (t_mm.launches, t_attn.launches, t_head.launches)
    x, wq, s = _mm_inputs(4, M=5, K=64, N=32)
    args = (torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(s))
    torch.testing.assert_close(t_mm.int8_matmul(*args, layer=1),
                               t_mm.int8_matmul_plain(*args, layer=1))
    t = [torch.from_numpy(a) for a in _attn_inputs(5)]
    torch.testing.assert_close(
        t_attn.int8_kv_decode_attention(*t[:5], t[5], t[6], layer=0),
        t_attn.int8_kv_decode_attention_plain(*t[:5], t[5], t[6], layer=0))
    hx = torch.randn(3, 64)
    hq = torch.randint(-127, 128, (64, 128), dtype=torch.int8)
    hs = torch.rand(128) * 0.01
    torch.testing.assert_close(
        t_head.lmhead_greedy(hx, torch.ones(64), hq, hs),
        t_head.lmhead_greedy_plain(hx, torch.ones(64), hq, hs))
    assert (t_mm.launches, t_attn.launches, t_head.launches) == before == \
        (0, 0, 0)


def _check_k1_plans(m, n, k):
    """Both routes' splits of K1: the stream route's (64-row m-block,
    256-column slab, 64-row k-tile) units are each taken once, every
    block's share within one unit of the mean; the wgmma route's K splits
    cover the k-tiles once, shares within one k-tile of each other; the
    rule sends decode rows (M <= 64) to the stream and prefill rows to
    wgmma."""
    for sms in (132, 114):
        pl = t_ws.plan(m, n, k, sms)
        seen = {}
        for b in range(pl.blocks):
            share = 0
            for mb, slab, k0, k1, j in pl.units(b):
                assert 0 <= j < pl.partials
                for kt in range(k0, k1):
                    seen[mb, slab, kt] = seen.get((mb, slab, kt), 0) + 1
                share += k1 - k0
            assert abs(share - pl.tiles / pl.blocks) < 1
        assert len(seen) == pl.tiles == -(-m // 64) * -(-n // 256) * \
            -(-k // 64) and set(seen.values()) == {1}
        splits, kt = t_mm._splits(m, n, k, sms), -(-k // 64)
        cuts = [z * kt // splits for z in range(splits + 1)]
        assert cuts[0] == 0 and cuts[-1] == kt
        shares = [b - a for a, b in zip(cuts, cuts[1:])]
        assert min(shares) >= 1 and max(shares) - min(shares) <= 1
    assert t_mm.pick_route(m, n, k) == ("stream" if m <= 64 else "wgmma")


def test_split_k_covers_k_exactly():
    """K1's splits at the decode shapes (the 7B linears, the lm_head, a
    ragged M and a small shape)."""
    for m, n, k in [(64, 4096, 4096), (64, 4096, 11008), (64, 6144, 4096),
                    (64, 22016, 4096), (64, 32000, 4096), (7, 6208, 4096),
                    (3, 10, 100)]:
        _check_k1_plans(m, n, k)


@pytest.mark.parametrize("m,n,k", [
    (m, n, k) for m in (128, 256, 512, 1024, 2047)
    for k, n in ((4096, 6144), (4096, 4096), (4096, 22016), (11008, 4096))])
def test_int8_matmul_plans_cover_every_unit_once(m, n, k):
    """K1's splits at the prefill rows of the 7B linears (K, N)."""
    _check_k1_plans(m, n, k)


def test_int8_matmul_padding_keeps_the_product():
    """Shapes whose rows are not whole 16-byte vectors (K % 8, N % 16) run
    on zero-padded copies: the first N columns of the padded product are
    the product."""
    for m, k, n in [(7, 200, 130), (300, 520, 1000), (5, 61, 33)]:
        x, wq, s = _mm_inputs(6, L=1, M=m, K=k, N=n)
        args = torch.from_numpy(x), torch.from_numpy(wq[0]), \
            torch.from_numpy(s[0])
        xp, wp, sp = t_mm._padded(*args)
        assert xp.shape[1] % 8 == 0 and wp.shape[1] % 16 == 0
        got = t_mm.int8_matmul_plain(xp, wp, sp)[:, :n]
        torch.testing.assert_close(got, t_mm.int8_matmul_plain(*args),
                                   rtol=1e-6, atol=1e-6)


def test_gpu_spec_knows_the_h100_sxm_only():
    from physics_llm_inference_tpu_torch.specs.gpu import (
        decode_step_floor_s, get_gpu_spec)

    spec = get_gpu_spec("NVIDIA H100 80GB HBM3")
    assert spec.hbm_bandwidth == 3.35e12 and spec.peak_flops == 989e12
    assert decode_step_floor_s(3_350_000, 0, spec) == pytest.approx(1e-6)
    for other in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(ValueError):
            get_gpu_spec(other)
