"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where torch sees no CUDA device. This file
imports no jax, so on a machine without it run it as
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
"""
import pytest
import torch

from physics_llm_inference_tpu_torch.kernels import flash_attention as t_fa
from physics_llm_inference_tpu_torch.kernels import fused_decode as t_fd
from physics_llm_inference_tpu_torch.kernels import int8_kv_attention as t_attn
from physics_llm_inference_tpu_torch.kernels import int8_matmul as t_mm
from physics_llm_inference_tpu_torch.kernels import lmhead as t_head
from physics_llm_inference_tpu_torch.models import transformer as ttf
from physics_llm_inference_tpu_torch.models.config import ModelConfig
from physics_llm_inference_tpu_torch.models.quant import (QuantizedTensor,
                                                          init_params_int8)
from physics_llm_inference_tpu_torch.ops.norms import rms_norm
from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies
from physics_llm_inference_tpu_torch.runtime.generate import cached_generate
from physics_llm_inference_tpu_torch.runtime.kv_cache import KVCache

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("m,k,n", [(64, 256, 384), (7, 200, 130),
                                   (1, 64, 16), (300, 520, 1000)])
def test_int8_matmul_kernel_matches_plain(dev, m, k, n):
    g = _gen(dev)
    x = torch.randn((m, k), generator=g, device=dev).bfloat16()
    wq = torch.randint(-127, 128, (2, k, n), dtype=torch.int8, generator=g,
                       device=dev)
    s = torch.rand((2, 1, n), generator=g, device=dev) / (73.9 * k ** 0.5)
    before = t_mm.launches
    got = t_mm.int8_matmul(x, wq, s, layer=1)
    torch.cuda.synchronize()
    assert t_mm.launches == before + 1
    want = t_mm.int8_matmul_plain(x, wq, s, layer=1)
    # different f32 summation order, then one bf16 round
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3 * float(want.float().abs().max()))


def test_int8_kv_attention_kernel_matches_plain(dev):
    g = _gen(dev, 1)
    L, B, S, hq, hkv, d = 2, 5, 300, 8, 2, 128
    q = torch.randn((B, hq, d), generator=g, device=dev).bfloat16()
    kq = torch.randint(-127, 128, (L, B, S, hkv * d), dtype=torch.int8,
                       generator=g, device=dev)
    vq = torch.randint(-127, 128, (L, B, S, hkv * d), dtype=torch.int8,
                       generator=g, device=dev)
    ks = torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.02
    vs = torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.02
    qslot = torch.tensor([299, 150, 7, 20, 128], dtype=torch.int32, device=dev)
    vfrom = torch.tensor([0, 5, 2, 20, 127], dtype=torch.int32, device=dev)
    got = t_attn.int8_kv_decode_attention(q, kq, ks, vq, vs, qslot, vfrom,
                                          layer=1)
    want = t_attn.int8_kv_decode_attention_plain(q, kq, ks, vq, vs, qslot,
                                                 vfrom, layer=1)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)


def test_lmhead_kernel_token_is_a_bf16_max(dev):
    g = _gen(dev, 2)
    B, D, V = 9, 512, 1000
    x = torch.randn((B, D), generator=g, device=dev).bfloat16()
    nw = torch.ones((D,), device=dev, dtype=torch.bfloat16)
    lq = torch.randint(-127, 128, (D, V), dtype=torch.int8, generator=g,
                       device=dev)
    ls = torch.full((V,), 1 / (73.9 * D ** 0.5), device=dev)
    tok = t_head.lmhead_greedy(x, nw, lq, ls).long()
    xn = rms_norm(x, nw, 1e-5)
    logits = t_mm.int8_matmul_plain(xn, lq, ls, out_dtype=torch.float32)
    logits = logits.bfloat16().float()
    top = logits.max(dim=-1).values
    picked = logits.gather(1, tok[:, None])[:, 0]
    ulp = torch.exp2(torch.floor(torch.log2(top.abs())) - 7)
    assert bool(((top - picked) <= ulp).all())


def test_fused_decode_config_raises_on_card(dev):
    # the W8A8 variant of the fused decode kernel is not ported: a decode
    # call that passes the fused gate with act_quant="int8" raises
    cfg = ModelConfig(vocab_size=512, hidden_dim=256, num_layers=1,
                      num_heads=2, num_kv_heads=1, intermediate_dim=256,
                      act_quant="int8")
    params = init_params_int8(_gen(dev), cfg)
    cache = KVCache.create(cfg, 8, 16, dtype=torch.int8, device=dev)
    ids = torch.ones((8, 1), dtype=torch.int64, device=dev)
    with pytest.raises(NotImplementedError, match="fused"):
        ttf.forward(params, ids, cfg, kv=cache.as_slice(), greedy_head=True)


def _row_rel(a, b):
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


FUSED = ModelConfig(vocab_size=512, hidden_dim=512, num_layers=2,
                    num_heads=4, num_kv_heads=2, intermediate_dim=768,
                    max_seq_len=64)


@pytest.mark.parametrize("write_cache", [False, True])
def test_fused_decode_kernel_matches_plain(dev, write_cache):
    cfg, B, S = FUSED, 8, 40
    g = _gen(dev, 3)
    blocks = init_params_int8(g, cfg)["blocks"]
    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    kq = torch.randint(-127, 128, (L, B, S, hkv * hd), dtype=torch.int8,
                       generator=g, device=dev)
    vq = torch.randint(-127, 128, (L, B, S, hkv * hd), dtype=torch.int8,
                       generator=g, device=dev)
    ks = torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.05
    vs = torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.05
    x = torch.randn((B, cfg.hidden_dim), generator=g, device=dev).bfloat16()
    slot = 33
    qslot = torch.full((B,), slot, dtype=torch.int32, device=dev)
    vfrom = torch.tensor([0, 3, 7, 30, 0, 12, 1, 33], dtype=torch.int32,
                         device=dev)
    pos = slot - vfrom
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    caches = [t.clone() for t in (kq, ks, vq, vs)]
    kw = dict(slot=slot, write_cache=True) if write_cache else {}
    before = t_fd.launches
    got = t_fd.fused_decode_step(blocks, x, *caches, qslot, vfrom, cos[pos],
                                 sin[pos], cfg, **kw)
    torch.cuda.synchronize()
    assert t_fd.launches == before + 1
    plain = [t.clone() for t in (kq, ks, vq, vs)]
    want = t_fd.fused_decode_step_plain(blocks, x, *plain, qslot, vfrom,
                                        cos[pos], sin[pos], cfg, **kw)
    # different f32 summation orders over two layers of an f32 residual
    assert _row_rel(got[0].float(), want[0].float()) < 2e-2
    if write_cache:
        for a, b, c in zip(got[1:], want[1:], (kq, ks, vq, vs)):
            # every byte outside the slot is unchanged
            outside = torch.ones(a.shape[2 if a.dtype == torch.int8 else 3],
                                 dtype=torch.bool, device=dev)
            outside[slot] = False
            idx = (slice(None), slice(None), outside) if a.dtype == \
                torch.int8 else (slice(None), slice(None), slice(None),
                                 outside)
            assert torch.equal(a[idx], c[idx])
            sel = (slice(None), slice(None), slot) if a.dtype == \
                torch.int8 else (slice(None), slice(None), slice(None), slot)
            assert (a[sel].float() - b[sel].float()).abs().max() <= \
                (1 if a.dtype == torch.int8 else 2e-2 * b[sel].abs().max())
    else:
        # codes: one int8 level where the f32 sums round apart
        for a, b in ((got[1], want[1]), (got[3], want[3])):
            d = (a.int() - b.int()).abs()
            assert int(d.max()) <= 1 and float((d == 0).float().mean()) > 0.99
        for a, b in ((got[2], want[2]), (got[4], want[4])):
            torch.testing.assert_close(a, b, rtol=2e-2, atol=0)


def test_default_config_generates_through_fused_kernel(dev):
    cfg = ModelConfig(vocab_size=512, hidden_dim=512, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_dim=768,
                      max_seq_len=256)
    params = init_params_int8(_gen(dev, 4), cfg)
    before = t_fd.launches
    out = cached_generate(params, cfg, [[5, 9, 2], [7] * 20], 6,
                          temperature=0.0, kv_dtype=torch.int8)
    assert out.tokens.shape == (2, 6)
    # B = 2 fails the gate (b % 8): per-op; B = 8 passes it: fused
    assert t_fd.launches == before
    out = cached_generate(params, cfg, [[3, 1 + i] for i in range(8)], 6,
                          temperature=0.0, kv_dtype=torch.int8)
    assert out.tokens.shape == (8, 6) and t_fd.launches == before + 6
    assert int(out.tokens.min()) >= 0 and int(out.tokens.max()) < 512


@pytest.mark.parametrize("b,hq,hkv,sq,sk,qoff,kv_len", [
    (2, 8, 2, 200, 200, 0, None),
    (3, 32, 8, 64, 300, [236, 100, 0], 290),
    (2, 6, 1, 33, 100, [67, 40], None),
])
def test_flash_kernel_matches_plain(dev, b, hq, hkv, sq, sk, qoff, kv_len):
    g = _gen(dev, 5)
    q = torch.randn((b, sq, hq, 128), generator=g, device=dev).bfloat16()
    k = torch.randn((b, sk, hkv, 128), generator=g, device=dev).bfloat16()
    v = torch.randn((b, sk, hkv, 128), generator=g, device=dev).bfloat16()
    qoff = torch.tensor(qoff, device=dev) if isinstance(qoff, list) else qoff
    vfrom = torch.tensor([5, 0, 17][:b], dtype=torch.int32, device=dev)
    # strided (B, S, H, d) views, as block_forward passes them
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    before = t_fa.launches
    got = t_fa.flash_attention(*args, q_offset=qoff, kv_len=kv_len,
                               valid_from=vfrom)
    torch.cuda.synchronize()
    assert t_fa.launches == before + 1
    want = t_fa.flash_attention_plain(*args, q_offset=qoff, kv_len=kv_len,
                                      valid_from=vfrom)
    assert bool(torch.isfinite(got).all())
    qpos = torch.as_tensor(qoff, device=dev).reshape(-1, 1) + \
        torch.arange(sq, device=dev)
    live = qpos >= vfrom[:, None]            # (B, Sq): rows past the padding
    err = (got.float() - want.float()).abs().transpose(1, 2)[live]
    assert float(err.max()) <= 2e-2


def test_prefill_linear_is_exact_in_f32(dev):
    """The prefill linear (m >= 2048 on the card) against an f64
    reference: bf16(q) is exact, the sum is f32, the scale comes after the
    dot. Rounding q * s to bf16 first (the earlier form) costs ~1e-3."""
    g = _gen(dev, 6)
    m, k, n = 2048, 4096, 512
    x = torch.randn((m, k), generator=g, device=dev).bfloat16()
    w = QuantizedTensor(
        torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g,
                      device=dev),
        torch.rand((1, n), generator=g, device=dev) / (73.9 * k ** 0.5))
    ref = (x.double() @ w.q.double()) * w.s.double()
    got = ttf._linear_f32(x, w)
    assert got.dtype == torch.float32
    assert _row_rel(got.double(), ref) < 1e-5
    assert _row_rel((x @ w.dequantize(torch.bfloat16)).double(), ref) > 1e-5


def _paged_tables(g, dev, B, MB, NB, lens, bs, trash):
    """Scattered tables: each request's live blocks from a permutation of
    the pool, dead columns and inactive rows (length < 0 here) at trash."""
    perm = torch.randperm(NB - 1, generator=g, device=dev)
    perm = perm[perm != trash][:B * MB].reshape(B, MB).to(torch.int32)
    tables = torch.full((B, MB), trash, dtype=torch.int32, device=dev)
    for b, n in enumerate(lens):
        used = min(-(-max(n, 0) // bs), MB)
        tables[b, :used] = perm[b, :used]
    return tables


@pytest.mark.parametrize("bs,mb", [(16, 8), (128, 2)])
def test_paged_attention_kernels_match_plain(dev, bs, mb):
    from physics_llm_inference_tpu_torch.kernels import paged_attention as t_pa

    g = _gen(dev, 7)
    lens = [0, 1, bs, bs + 1, mb * bs, mb * bs + 9, 37]
    B = len(lens)
    L, NB, hq, hkv, d = 2, B * mb + 2, 8, 2, 128
    tables = _paged_tables(g, dev, B, mb, NB, lens, bs, NB - 1)
    ctx = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((B, hq, d), generator=g, device=dev).bfloat16()
    kv = torch.randint(-127, 128, (L, NB, 2, bs, hkv * d), dtype=torch.int8,
                       generator=g, device=dev)
    kvs = torch.rand((L, NB, 2, hkv, bs), generator=g, device=dev) * 0.02
    kp = torch.randn((L, NB, bs, hkv, d), generator=g, device=dev).bfloat16()
    vp = torch.randn((L, NB, bs, hkv, d), generator=g, device=dev).bfloat16()
    b6, b7 = t_pa.int8_paged_launches, t_pa.paged_launches
    got6 = t_pa.int8_paged_decode_attention(q, kv, kvs, tables, ctx, layer=1)
    got7 = t_pa.paged_decode_attention(q, kp, vp, tables, ctx, layer=1)
    torch.cuda.synchronize()
    assert (t_pa.int8_paged_launches, t_pa.paged_launches) == (b6 + 1, b7 + 1)
    want6 = t_pa.int8_paged_decode_attention_plain(q, kv, kvs, tables, ctx,
                                                   layer=1)
    want7 = t_pa.paged_decode_attention_plain(q, kp, vp, tables, ctx, layer=1)
    # other f32 summation orders and tile-wise online softmax; K6 rounds
    # p * v_scale to bf16 against its running max; outputs in bf16
    torch.testing.assert_close(got6.float(), want6.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(got7.float(), want7.float(), rtol=0, atol=2e-2)
    assert not got6[0].any() and not got7[0].any()       # no key: zeros


@pytest.mark.parametrize("inplace", [False, True])
def test_fused_paged_decode_kernel_matches_plain(dev, inplace):
    cfg, B, bs, mb = FUSED, 8, 16, 4
    g = _gen(dev, 8)
    blocks = init_params_int8(g, cfg)["blocks"]
    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    NB = B * mb + 4
    trash = NB - 1
    lens = [0, 15, 16, 17, 63, 64, 30, 5]                 # 64 = MB·BS: stale
    active = torch.tensor([n < mb * bs for n in lens], device=dev)
    lens[7] = -1                                          # marks row 7
    tables = _paged_tables(g, dev, B, mb, NB, lens, bs, trash)
    lens[7] = 5                                           # inactive: trash
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    kv = torch.randint(-127, 128, (L, NB, 2, bs, hkv * hd), dtype=torch.int8,
                       generator=g, device=dev)
    kvs = torch.rand((L, NB, 2, hkv, bs), generator=g, device=dev) * 0.05
    x = torch.randn((B, cfg.hidden_dim), generator=g, device=dev).bfloat16()
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    pos = lengths.long().clamp(max=cfg.max_seq_len - 1)
    pools = [kv.clone(), kvs.clone()]
    before = t_fd.paged_launches
    got = t_fd.fused_paged_decode_step(blocks, x, *pools, tables, lengths,
                                       cos[pos], sin[pos], cfg,
                                       inplace=inplace)
    torch.cuda.synchronize()
    assert t_fd.paged_launches == before + 1
    plain = [kv.clone(), kvs.clone()]
    want = t_fd.fused_paged_decode_step_plain(blocks, x, *plain, tables,
                                              lengths, cos[pos], sin[pos],
                                              cfg, inplace=inplace)
    # different f32 summation orders over two layers of an f32 residual
    assert _row_rel(got[0].float(), want[0].float()) < 2e-2
    for a, b in ((got[1], want[1]), (got[3], want[3])):
        d = (a.int() - b.int()).abs()
        assert int(d.max()) <= 1 and float((d == 0).float().mean()) > 0.99
    if inplace:
        # outside the written slots and the trash block nothing changed;
        # at them the codes are the returned ones
        from physics_llm_inference_tpu_torch.kernels.paged_attention import \
            write_position
        blk, off = write_position(tables, lengths, bs)
        mask = torch.zeros((NB, bs), dtype=torch.bool, device=dev)
        mask[blk, off] = True
        mask[trash] = True
        assert torch.equal(pools[0].transpose(2, 3)[:, ~mask],
                           kv.transpose(2, 3)[:, ~mask])
        for r in range(B):
            if bool(active[r]) and int(tables[r, 0]) != trash:
                assert torch.equal(pools[0][:, blk[r], 0, off[r]], got[1][:, r])
                assert torch.equal(pools[1][:, blk[r], 1, :, off[r]],
                                   got[4][:, r])
    # fixed-order sums: a second launch on the same inputs, the same bits
    again = t_fd.fused_paged_decode_step(blocks, x, kv.clone(), kvs.clone(),
                                         tables, lengths, cos[pos], sin[pos],
                                         cfg, inplace=inplace)
    assert torch.equal(again[0], got[0])


def test_paged_engine_routes_through_the_kernels(dev):
    from physics_llm_inference_tpu_torch.kernels import paged_attention as t_pa
    from physics_llm_inference_tpu_torch.serve.engine import GenerationRequest
    from physics_llm_inference_tpu_torch.serve.paged_engine import (
        PagedEngineConfig, PagedInferenceEngine)

    cfg = ModelConfig(vocab_size=512, hidden_dim=512, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_dim=768,
                      max_seq_len=256)
    params = init_params_int8(_gen(dev, 9), cfg)
    routes = {  # engine geometry -> the decode kernel it must launch
        "fused": (dict(block_size=128, max_blocks_per_request=2,
                       kv_dtype="int8"), t_fd, "paged_launches"),
        "int8": (dict(block_size=16, max_blocks_per_request=16,
                      kv_dtype="int8"), t_pa, "int8_paged_launches"),
        "bf16": (dict(block_size=16, max_blocks_per_request=16), t_pa,
                 "paged_launches"),
    }
    for name, (kw, mod, counter) in routes.items():
        eng = PagedInferenceEngine(params, cfg, PagedEngineConfig(
            num_blocks=40, max_batch=8, prompt_buckets=(16, 32, 64), **kw))
        before = getattr(mod, counter)
        rids = [eng.submit_request(GenerationRequest(
            prompt_tokens=[3 + i] * (5 + 7 * i), max_tokens=9,
            temperature=0.0)) for i in range(6)]
        eng.run_until_done(rids)
        assert getattr(mod, counter) > before, name
        for r in rids:
            toks = eng.get_result(r).tokens
            assert len(toks) == 9 and 0 <= min(toks) and max(toks) < 512


@pytest.mark.parametrize("dtype,m,k,n", [
    (torch.bfloat16, 256, 512, 768),
    (torch.bfloat16, 100, 72, 200),      # ragged for the 128 x 128 tile
    (torch.float32, 256, 512, 768),
    (torch.float32, 100, 72, 200),
])
def test_tiled_matmul_kernel_matches_plain(dev, dtype, m, k, n):
    from physics_llm_inference_tpu_torch.kernels import matmul as t_tm

    g = _gen(dev, 10)
    a = torch.randn((m, k), generator=g, device=dev).to(dtype)
    b = torch.randn((k, n), generator=g, device=dev).to(dtype)
    before = t_tm.launches
    for out_dtype in (None, torch.float32):
        got = t_tm.tiled_matmul(a, b, out_dtype=out_dtype).float()
        want = t_tm.tiled_matmul_plain(a, b, out_dtype).float()
        # another f32 summation order, then one cast: bf16 rtol 1e-2, f32
        # (full f32 on both sides, allow_tf32 off) rtol 1e-4
        rtol = 1e-2 if dtype == torch.bfloat16 and out_dtype is None else 1e-4
        torch.testing.assert_close(got, want, rtol=rtol,
                                   atol=rtol * float(want.abs().max()))
    assert t_tm.launches == before + 2


@pytest.mark.parametrize("rows,block_rows,stride", [(4096, 2048, 1),
                                                   (4096, 8, 32),
                                                   (1000, 8, 4)])
def test_membench_copies_match_plain(dev, rows, block_rows, stride):
    from physics_llm_inference_tpu_torch.kernels import membench as t_mem

    x = torch.randn((rows, 128), generator=_gen(dev, 11), device=dev)
    if stride == 1:
        got = t_mem._stream_copy(x, block_rows=block_rows)
        want = t_mem._stream_copy_plain(x, block_rows)
    else:
        got = t_mem._strided_copy(x, block_rows=block_rows, stride=stride)
        want = t_mem._strided_copy_plain(x, block_rows, stride)
    assert torch.equal(got, want)


def test_measure_access_patterns_launches_both_copies(dev):
    from physics_llm_inference_tpu_torch.kernels import membench as t_mem

    before = (t_mem.stream_launches, t_mem.strided_launches)
    out = t_mem.measure_access_patterns(total_mb=16, iters=2)
    assert out["stream_gbps"] > 0 and out["strided_gbps"] > 0
    assert t_mem.stream_launches > before[0]
    assert t_mem.strided_launches > before[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(512, 128), (300, 100)])
def test_vector_add_kernel_is_bit_equal_to_torch_add(dev, dtype, shape):
    from physics_llm_inference_tpu_torch.kernels import hello_pallas as t_va

    g = _gen(dev, 12)
    a = torch.randn(shape, generator=g, device=dev).to(dtype)
    b = torch.randn(shape, generator=g, device=dev).to(dtype)
    before = t_va.launches
    got = t_va.vector_add(a, b, block_rows=100 if shape[0] == 300 else 256)
    assert t_va.launches == before + 1
    assert torch.equal(got, t_va.vector_add_plain(a, b))
    assert torch.equal(got, torch.add(a, b))


def test_weight_carriers_default_to_the_card(dev):
    """params_from_jax, kv_from_jax and paged_kv_from_jax put their tensors
    on the card unless the caller names another device."""
    from types import SimpleNamespace

    import numpy as np

    from physics_llm_inference_tpu_torch import convert

    rng = np.random.default_rng(0)
    quant = SimpleNamespace(
        q=rng.integers(-127, 128, (2, 4, 6)).astype(np.int8),
        s=rng.random((2, 1, 6)).astype(np.float32))
    tree = {"embed": rng.random((8, 4)).astype(np.float32),
            "norm": np.ones(4, np.float32), "lm_head": quant,
            "blocks": {"wqkv": quant, "ln1": np.ones((2, 4), np.float32)}}
    params = convert.params_from_jax(tree)
    assert params["embed"].is_cuda and params["lm_head"].q.is_cuda
    assert params["blocks"]["wqkv"].s.is_cuda
    cache = SimpleNamespace(k=quant, v=quant, length=3)
    kv = convert.kv_from_jax(cache)
    assert kv.k.q.is_cuda and kv.v.s.is_cuda
    pk, pv = convert.paged_kv_from_jax(quant)
    assert pk.q.is_cuda and pv is None
    k, v = convert.paged_kv_from_jax(tree["embed"], tree["embed"])
    assert k.is_cuda and v.is_cuda
    assert not convert.params_from_jax(tree, device="cpu")["embed"].is_cuda
