"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where torch sees no CUDA device. This file
imports no jax, so on a machine without it run it as
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
"""
import dataclasses

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
                                                          init_params_int4,
                                                          init_params_int8)
from physics_llm_inference_tpu_torch.ops.norms import rms_norm
from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies
from physics_llm_inference_tpu_torch.runtime.generate import (
    DecodeLoop, cached_generate, decode_step_cache)
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


# K1 at the 7B widths (wqkv, w_down) at decode and prefill rows, and the
# ragged shapes (K % 8 or N % 16: zero-padded copies)
K1_CASES = [(m, k, n) for m in (1, 7, 64, 65, 128, 256, 300, 512, 1024, 2047)
            for k, n in ((4096, 6144), (11008, 4096))] + [
    (64, 256, 384), (7, 200, 130), (1, 64, 16), (300, 520, 1000)]


@pytest.mark.parametrize("route", t_mm.ROUTES)
@pytest.mark.parametrize("m,k,n", K1_CASES)
def test_int8_matmul_kernel_matches_plain(dev, m, k, n, route):
    g = _gen(dev)
    x = torch.randn((m, k), generator=g, device=dev).bfloat16()
    wq = torch.randint(-127, 128, (2, k, n), dtype=torch.int8, generator=g,
                       device=dev)
    s = torch.rand((2, 1, n), generator=g, device=dev) / (73.9 * k ** 0.5)
    before = (t_mm.launches, t_mm.stream_launches, t_mm.wgmma_launches)
    got = t_mm._launch(route, x, wq[1], s[1])
    torch.cuda.synchronize()
    assert (t_mm.launches, t_mm.stream_launches, t_mm.wgmma_launches) == (
        before[0] + 1, before[1] + (route == "stream"),
        before[2] + (route == "wgmma"))
    want = t_mm.int8_matmul_plain(x, wq, s, layer=1)
    # different f32 summation order, then one bf16 round
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3 * float(want.float().abs().max()))
    # fixed-order sums: a second launch gives the same bits
    assert torch.equal(t_mm._launch(route, x, wq[1], s[1]), got)
    # the entry point takes the rule's route: the same bits on that route
    if route == t_mm.pick_route(m, n, k):
        assert torch.equal(t_mm.int8_matmul(x, wq, s, layer=1), got)


# (valid_from, q_slot) rows: live ranges of 1, 15, 16, 17, 33, 146 and 300
# keys, most starting off the 16-key grid, and 2 keys across it: the warp
# split and the 16-key step's ragged ends
K2_RANGES = [(20, 20), (3, 17), (21, 36), (7, 23), (33, 65), (5, 150),
             (0, 299), (127, 128)]


def _k2_inputs(dev, seed, B, S, hq, hkv, d, L=2):
    g = _gen(dev, seed)
    q = torch.randn((B, hq, d), generator=g, device=dev).bfloat16()
    kq = torch.randint(-127, 128, (L, B, S, hkv * d), dtype=torch.int8,
                       generator=g, device=dev)
    vq = torch.randint(-127, 128, (L, B, S, hkv * d), dtype=torch.int8,
                       generator=g, device=dev)
    ks = torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.02
    vs = torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.02
    return q, kq, ks, vq, vs


# groups 4, 1 and 8; head_dim 128 and 64
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (8, 8, 128), (16, 2, 128),
                                      (16, 2, 64)])
def test_int8_kv_attention_kernel_matches_plain(dev, hq, hkv, d):
    B, S = len(K2_RANGES), 300
    args = _k2_inputs(dev, 1, B, S, hq, hkv, d)
    vfrom, qslot = (torch.tensor(c, dtype=torch.int32, device=dev)
                    for c in zip(*K2_RANGES))
    got = t_attn.int8_kv_decode_attention(*args, qslot, vfrom, layer=1)
    want = t_attn.int8_kv_decode_attention_plain(*args, qslot, vfrom, layer=1)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2e-2)


def test_int8_kv_attention_kernel_two_launches_bit_equal(dev):
    """At the 7B heads (B 64, S 256, ragged ranges): the warps' states merge
    in a fixed order, so a second launch gives the same bits."""
    B, S = 64, 256
    args = _k2_inputs(dev, 8, B, S, 32, 8, 128)
    g = _gen(dev, 9)
    qslot = torch.randint(128, S, (B,), generator=g, device=dev).int()
    vfrom = torch.randint(0, 128, (B,), generator=g, device=dev).int()
    got = t_attn.int8_kv_decode_attention(*args, qslot, vfrom, layer=1)
    assert torch.equal(
        t_attn.int8_kv_decode_attention(*args, qslot, vfrom, layer=1), got)


@pytest.mark.parametrize("B,D,V", [(9, 512, 1000), (64, 4096, 32000)])
def test_lmhead_kernel_token_is_a_bf16_max(dev, B, D, V):
    g = _gen(dev, 2)
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


def _row_rel(a, b):
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


FUSED = ModelConfig(vocab_size=512, hidden_dim=512, num_layers=2,
                    num_heads=4, num_kv_heads=2, intermediate_dim=768,
                    max_seq_len=64)
# each K4 mode: its weights, its act_quant and its launch counter; at FUSED's
# widths the INT4 w_down (K = 768) has 3 scale groups
MODES = {"w8a16": (init_params_int8, "none", "launches"),
         "w4a16": (init_params_int4, "none", "w4a16_launches"),
         "w8a8": (init_params_int8, "int8", "w8a8_launches")}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("write_cache", [False, True])
def test_fused_decode_kernel_matches_plain(dev, write_cache, mode):
    init, act, counter = MODES[mode]
    cfg, B, S = dataclasses.replace(FUSED, act_quant=act), 8, 40
    g = _gen(dev, 3)
    blocks = init(g, cfg)["blocks"]
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
    if mode == "w8a8":
        vfrom[4:] = slot      # rows 4-7 attend to their own token alone
    pos = slot - vfrom
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    caches = [t.clone() for t in (kq, ks, vq, vs)]
    kw = dict(slot=qslot, write_cache=True) if write_cache else {}
    before = {c: getattr(t_fd, c) for _, _, c in MODES.values()}
    got = t_fd.fused_decode_step(blocks, x, *caches, qslot, vfrom, cos[pos],
                                 sin[pos], cfg, **kw)
    torch.cuda.synchronize()
    # the mode's own counter, and no other
    assert {c: getattr(t_fd, c) - n for c, n in before.items()} == {
        c: int(c == counter) for c in before}
    plain = [t.clone() for t in (kq, ks, vq, vs)]
    want = t_fd.fused_decode_step_plain(blocks, x, *plain, qslot, vfrom,
                                        cos[pos], sin[pos], cfg, **kw)
    rel = (got[0].float() - want[0].float()).norm(dim=-1) \
        / want[0].float().norm(dim=-1)
    # the (layer, row) pairs whose new K/V codes are held
    held = torch.ones((L, B), dtype=torch.bool, device=dev)
    if mode == "w8a8":
        # the kernel's online softmax over key tiles rounds p * v_scale to
        # bf16 apart from the plain version's one softmax, and a flipped int8
        # activation code moves a row by a few percent and every later
        # layer's codes; with no cached key live, attention is the token's V
        # in both and every product exact in int32
        exact = vfrom == slot
        assert float(rel[exact].max()) < 2e-3 and float(rel.max()) < 1e-1
        held[1:] = exact
    else:
        # different f32 summation orders over two layers of an f32 residual
        assert float(rel.max()) < 2e-2
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
            tol = 1 if a.dtype == torch.int8 else 2e-2 * b[sel].abs().max()
            assert (a[sel][held].float() - b[sel][held].float()).abs().max() \
                <= tol
    else:
        # codes: one int8 level where the f32 sums round apart
        for a, b in ((got[1], want[1]), (got[3], want[3])):
            d = (a[held].int() - b[held].int()).abs()
            assert int(d.max()) <= 1 and float((d == 0).float().mean()) > 0.99
        for a, b in ((got[2], want[2]), (got[4], want[4])):
            torch.testing.assert_close(a[held], b[held], rtol=2e-2, atol=0)


# a hidden width (and QO, 2F) that is no multiple of the 256-column slab, an
# intermediate width (w_down's K) no multiple of the 64-row k-tile, B = 5
RAGGED = ModelConfig(vocab_size=512, hidden_dim=400, num_layers=2,
                     num_heads=5, num_kv_heads=1, intermediate_dim=296,
                     max_seq_len=64)
# W4A16 needs N % 32 == 0: INT4 scale groups of 16 rows (w_down, the least
# the wrapper takes: 2F % 32 == 0 makes F % 16 == 0), 32 (wqkv, w_gate_up;
# K = 416 also cuts the last k-tile) and 128 (wo: its 12 units are 12
# blocks' whole shares, so every group is split between two runs)
RAGGED_W4 = ModelConfig(vocab_size=512, hidden_dim=416, num_layers=2,
                        num_heads=6, num_kv_heads=2, intermediate_dim=304,
                        max_seq_len=64, head_dim_override=64)
# kernel: (config, weights, launch counter); W8A8's F % 16 == 8 pads a8's
# rows to a 16-byte pitch
STREAMING = {"k4": (RAGGED, init_params_int8, "launches"),
             "k8": (RAGGED, init_params_int8, "paged_launches"),
             "w4a16": (RAGGED_W4, init_params_int4, "w4a16_launches"),
             "w8a8": (dataclasses.replace(RAGGED, act_quant="int8"),
                      init_params_int8, "w8a8_launches")}


@pytest.mark.parametrize("kernel", list(STREAMING))
def test_streaming_kernels_on_ragged_shapes(dev, kernel):
    """K4 in each mode and K8 at B = 5 where the plan's slabs, k-tiles and
    the TMA boxes are cut: against their plain versions, and bit-equal
    twice."""
    cfg, init, counter = STREAMING[kernel]
    B = 5
    g = _gen(dev, 9)
    blocks = init(g, cfg)["blocks"]
    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    x = torch.randn((B, cfg.hidden_dim), generator=g, device=dev).bfloat16()
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    # the (layer, row) pairs whose new K/V codes are held
    held = torch.ones((L, B), dtype=torch.bool, device=dev)
    if kernel != "k8":
        S, slot = 40, 33
        cache = [torch.randint(-127, 128, (L, B, S, hkv * hd), dtype=torch.int8,
                               generator=g, device=dev),
                 torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.05]
        cache += [torch.randint(-127, 128, (L, B, S, hkv * hd),
                                dtype=torch.int8, generator=g, device=dev),
                  torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.05]
        qslot = torch.full((B,), slot, dtype=torch.int32, device=dev)
        vfrom = torch.tensor([0, 3, 30, 12, 33], dtype=torch.int32, device=dev)
        pos = slot - vfrom
        args = (qslot, vfrom, cos[pos], sin[pos], cfg)

        def run(fn):
            return fn(blocks, x, *[t.clone() for t in cache], *args)

        before = getattr(t_fd, counter)
        got, again = run(t_fd.fused_decode_step), run(t_fd.fused_decode_step)
        want = run(t_fd.fused_decode_step_plain)
    else:
        bs, mb = 16, 3
        NB = B * mb + 2
        lens = [0, 15, 16, 40, 47]
        tables = _paged_tables(g, dev, B, mb, NB, lens, bs, NB - 1)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        kv = torch.randint(-127, 128, (L, NB, 2, bs, hkv * hd),
                           dtype=torch.int8, generator=g, device=dev)
        kvs = torch.rand((L, NB, 2, hkv, bs), generator=g, device=dev) * 0.05
        args = (tables, lengths, cos[lengths.long()], sin[lengths.long()], cfg)

        def run(fn):
            return fn(blocks, x, kv.clone(), kvs.clone(), *args)

        before = getattr(t_fd, counter)
        got = run(t_fd.fused_paged_decode_step)
        again = run(t_fd.fused_paged_decode_step)
        want = run(t_fd.fused_paged_decode_step_plain)
    torch.cuda.synchronize()
    assert getattr(t_fd, counter) == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert bool(torch.isfinite(got[0].float()).all())
    rel = (got[0].float() - want[0].float()).norm(dim=-1) \
        / want[0].float().norm(dim=-1)
    if kernel == "w8a8":
        # as test_fused_decode_kernel_matches_plain: the tiled softmax rounds
        # apart and a flipped int8 activation code moves a row by a few
        # percent and layer 1's codes; row 4 attends its own token alone
        # (exact attention, every product exact in int32)
        exact = vfrom == slot
        assert float(rel[exact].max()) < 2e-3 and float(rel.max()) < 1e-1
        assert float(rel.median()) < 2e-2
        held[1:] = exact
    else:
        # different f32 summation orders over two layers of an f32 residual
        assert float(rel.max()) < 2e-2
    for a, b in ((got[1], want[1]), (got[3], want[3])):
        # layer 0 sees the same input: a bf16 rounding of qkv may flip a
        # code; layer 1 also sees layer 0's rounding, on only 5 x 80 codes
        d = (a[held].int() - b[held].int()).abs()
        assert int(d.max()) <= 1
        assert float((d[:B] == 0).float().mean()) > 0.99
    for a, b in ((got[2], want[2]), (got[4], want[4])):
        torch.testing.assert_close(a[held], b[held], rtol=2e-2, atol=0)


def test_default_config_generates_through_fused_kernel(dev):
    cfg = ModelConfig(vocab_size=512, hidden_dim=512, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_dim=768,
                      max_seq_len=256)
    params = init_params_int8(_gen(dev, 4), cfg)
    steps = decode_step_cache()
    before = t_fd.launches
    out = cached_generate(params, cfg, [[5, 9, 2], [7] * 20], 6,
                          temperature=0.0, kv_dtype=torch.int8,
                          step_cache=steps)
    assert out.tokens.shape == (2, 6)
    # B = 2 fails the gate (b % 8): per-op; B = 8 passes it: fused, one
    # launch a step once the loop is captured (the capture's warm-up step
    # launches once more)
    assert t_fd.launches == before
    prompts = [[3, 1 + i] for i in range(8)]
    cached_generate(params, cfg, prompts, 6, temperature=0.0,
                    kv_dtype=torch.int8, step_cache=steps)
    before = t_fd.launches
    out = cached_generate(params, cfg, prompts, 6, temperature=0.0,
                          kv_dtype=torch.int8, step_cache=steps)
    assert out.tokens.shape == (8, 6) and t_fd.launches == before + 6
    assert int(out.tokens.min()) >= 0 and int(out.tokens.max()) < 512


@pytest.mark.parametrize("mode", ["w4a16", "w8a8"])
def test_w4a16_and_w8a8_generate_through_their_kernel_modes(dev, mode):
    """INT4 stacks decode through K4's W4A16 mode, act_quant="int8" through
    its W8A8 mode, each step one launch of that mode and none of another;
    W4A8 takes the per-op path, as in the reference."""
    init, act, counter = MODES[mode]
    cfg = dataclasses.replace(FUSED, act_quant=act, max_seq_len=256)
    params = init(_gen(dev, 4), cfg)
    steps = decode_step_cache()
    prompts = [[3, 1 + i] for i in range(8)]
    cached_generate(params, cfg, prompts, 6, temperature=0.0,
                    kv_dtype=torch.int8, step_cache=steps)
    before = {c: getattr(t_fd, c) for _, _, c in MODES.values()}
    out = cached_generate(params, cfg, prompts, 6, temperature=0.0,
                          kv_dtype=torch.int8, step_cache=steps)
    assert out.tokens.shape == (8, 6)
    assert int(out.tokens.min()) >= 0 and int(out.tokens.max()) < 512
    assert {c: getattr(t_fd, c) - n for c, n in before.items()} == {
        c: 6 * int(c == counter) for c in before}
    if mode == "w4a16":
        w4a8 = dataclasses.replace(cfg, act_quant="int8")
        cache = KVCache.create(w4a8, 8, 16, dtype=torch.int8, device=dev)
        assert not ttf._fused_decode_ok(params, w4a8, 8, cache.as_slice())


@pytest.mark.parametrize("b,hq,hkv,sq,sk,qoff,kv_len,d", [
    (2, 8, 2, 200, 200, 0, None, 128),
    (3, 32, 8, 64, 300, [236, 100, 0], 290, 128),
    (2, 6, 1, 33, 100, [67, 40], None, 128),      # group 6: 21-position tiles
    (2, 4, 4, 150, 150, 0, None, 64),             # group 1, d 64
    (2, 16, 2, 70, 1024, [900, 0], 1000, 128),    # group 8, a paged chunk
    (1, 64, 1, 9, 40, 31, None, 64),              # group 64: 2-position tiles
])
def test_flash_kernel_matches_plain(dev, b, hq, hkv, sq, sk, qoff, kv_len, d):
    g = _gen(dev, 5)
    q = torch.randn((b, sq, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, sk, hkv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, sk, hkv, d), generator=g, device=dev).bfloat16()
    qoff = torch.tensor(qoff, device=dev) if isinstance(qoff, list) else qoff
    # request 0's valid_from 5 leaves its first rows with no live key in
    # the first tile (and, at q_offset 0, none at all)
    vfrom = torch.tensor([5, 0, 17][:b], dtype=torch.int32, device=dev)
    # strided (B, S, H, d) views, as block_forward passes them
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    before = t_fa.launches
    got = t_fa.flash_attention(*args, q_offset=qoff, kv_len=kv_len,
                               valid_from=vfrom)
    again = t_fa.flash_attention(*args, q_offset=qoff, kv_len=kv_len,
                                 valid_from=vfrom)
    torch.cuda.synchronize()
    assert t_fa.launches == before + 2
    assert torch.equal(got, again)           # a fixed order of sums
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


# groups 4 and 8, head_dim 128 and 64; K7 alone at head_dim 120 (% 8, not
# % 16: its tail k-step zero-filled)
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (16, 2, 128), (8, 2, 64),
                                      (8, 2, 120)])
@pytest.mark.parametrize("bs,mb", [(16, 8), (128, 2)])
def test_paged_attention_kernels_match_plain(dev, bs, mb, hq, hkv, d):
    from physics_llm_inference_tpu_torch.kernels import paged_attention as t_pa

    g = _gen(dev, 7)
    lens = [0, 1, bs, bs + 1, mb * bs, mb * bs + 9, 37, 15, 17, 33]
    B = len(lens)
    L, NB = 2, B * mb + 2
    tables = _paged_tables(g, dev, B, mb, NB, lens, bs, NB - 1)
    ctx = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((B, hq, d), generator=g, device=dev).bfloat16()
    kv = torch.randint(-127, 128, (L, NB, 2, bs, hkv * d), dtype=torch.int8,
                       generator=g, device=dev)
    kvs = torch.rand((L, NB, 2, hkv, bs), generator=g, device=dev) * 0.02
    kp = torch.randn((L, NB, bs, hkv, d), generator=g, device=dev).bfloat16()
    vp = torch.randn((L, NB, bs, hkv, d), generator=g, device=dev).bfloat16()
    cases = [(t_pa.paged_decode_attention, kp, vp, "paged_launches")]
    if d % 16 == 0:
        cases.append((t_pa.int8_paged_decode_attention, kv, kvs,
                      "int8_paged_launches"))
    for fn, a, b, counter in cases:
        before = getattr(t_pa, counter)
        got = fn(q, a, b, tables, ctx, layer=1)
        torch.cuda.synchronize()
        assert getattr(t_pa, counter) == before + 1
        want = getattr(t_pa, f"{fn.__name__}_plain")(q, a, b, tables, ctx,
                                                     layer=1)
        # other f32 summation orders and a warp-wise online softmax; K6
        # rounds p * v_scale to bf16 against its running max; bf16 out
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=2e-2)
        assert not got[0].any()                       # no key: zeros
        assert torch.equal(fn(q, a, b, tables, ctx, layer=1), got)


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
            if not bool(active[r]):
                continue
            # which of several writes to one position (the trash block's)
            # lands is unspecified: each element holds one writer's value
            at = (int(blk[r]), int(off[r]))
            writers = [s for s in range(B)
                       if (int(blk[s]), int(off[s])) == at]
            stored = (pools[0][:, at[0], 0, at[1]],
                      pools[1][:, at[0], 0, :, at[1]],
                      pools[0][:, at[0], 1, at[1]],
                      pools[1][:, at[0], 1, :, at[1]])
            for have, new in zip(stored, got[1:5]):
                cand = torch.stack([new[:, s] for s in writers])
                assert bool((cand == have).any(0).all()), (r, writers)
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


@pytest.mark.parametrize("dtype,m,k,n,body", [
    (torch.bfloat16, 256, 512, 768, "wgmma"),
    (torch.bfloat16, 100, 72, 200, "wgmma"),   # TMA zero-fills past M, N, K
    (torch.bfloat16, 64, 64, 100, "wmma"),     # N % 8 != 0: no TMA rows
    (torch.bfloat16, 128, 120, 130, "wmma"),
    (torch.float32, 256, 512, 768, "f32"),
    (torch.float32, 100, 72, 200, "f32"),
])
def test_tiled_matmul_kernel_matches_plain(dev, dtype, m, k, n, body):
    from physics_llm_inference_tpu_torch.kernels import matmul as t_tm

    counter = {"wgmma": "launches", "wmma": "wmma_launches",
               "f32": "f32_launches"}
    g = _gen(dev, 10)
    a = torch.randn((m, k), generator=g, device=dev).to(dtype)
    b = torch.randn((k, n), generator=g, device=dev).to(dtype)
    assert t_tm.route(a, b) == body
    before = {c: getattr(t_tm, c) for c in counter.values()}
    for out_dtype in (None, torch.float32):
        got = t_tm.tiled_matmul(a, b, out_dtype=out_dtype).float()
        want = t_tm.tiled_matmul_plain(a, b, out_dtype).float()
        # another f32 summation order, then one cast: bf16 rtol 1e-2, f32
        # (full f32 on both sides, allow_tf32 off) rtol 1e-4
        rtol = 1e-2 if dtype == torch.bfloat16 and out_dtype is None else 1e-4
        torch.testing.assert_close(got, want, rtol=rtol,
                                   atol=rtol * float(want.abs().max()))
    assert {c: getattr(t_tm, c) - before[c] for c in counter.values()} == \
        {c: 2 if c == counter[body] else 0 for c in counter.values()}


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


# (byte offset, lanes, block rows, stride): row blocks of 4, 12, 20 and
# 24 KB, one not a 16-byte multiple, an unaligned base
RAGGED_COPIES = [(0, 4096, 3, 1), (0, 20480, 1, 2), (16, 4096, 2, 3),
                 (0, 12288, 2, 1), (1, 4096, 1, 1), (0, 4088, 2, 2)]


@pytest.mark.parametrize("off,lanes,rows,stride", RAGGED_COPIES)
def test_row_block_copy_byte_equal_at_ragged_shapes(dev, off, lanes, rows,
                                                    stride):
    from physics_llm_inference_tpu_torch.kernels import membench as t_mem

    base = torch.randint(0, 256, (7 * 24576 + 48,), dtype=torch.uint8,
                         generator=_gen(dev, 13), device=dev)
    x = base[off:off + lanes * ((base.numel() - off) // lanes)].view(-1,
                                                                      lanes)
    blocks = x.shape[0] // (rows * stride)
    got = t_mem._row_block_copy(x, rows, stride, blocks)
    assert torch.equal(got, t_mem._row_blocks_plain(x, rows, stride, blocks))


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


# (element offset of a, rows, cols): whole 16-byte vectors and a tail,
# unaligned a and b
RAGGED_ADDS = [(0, 999_983, 3), (1, 1, 65_541), (0, 4096, 257), (8, 2048, 8),
               (0, 3, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off,rows,cols", RAGGED_ADDS)
def test_vector_add_bit_equal_to_torch_add_at_ragged_sizes(dev, dtype, off,
                                                           rows, cols):
    from physics_llm_inference_tpu_torch.kernels import hello_pallas as t_va

    flat = torch.randn(3 * 999_983 + 8, generator=_gen(dev, 14),
                       device=dev).to(dtype)
    a = flat[off:off + rows * cols].view(rows, cols)
    b = flat[-rows * cols:].view(rows, cols)
    before = t_va.launches
    got = t_va.vector_add(a, b, block_rows=rows)
    assert t_va.launches == before + 1
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


def test_captured_fused_step_replays_at_two_slots_bit_equal(dev):
    """K4 captured once in a CUDA graph, replayed with two write slots set
    in its static slot buffer: each replay bit-equal to an eager launch at
    that slot (x_out and the whole cache), one launch counted a replay."""
    from physics_llm_inference_tpu_torch.runtime.step_cache import \
        CapturedStep

    cfg = dataclasses.replace(FUSED, max_seq_len=64)
    g = _gen(dev, 21)
    blocks = init_params_int8(g, cfg)["blocks"]
    L, B, S = cfg.num_layers, 8, 48
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cache = [torch.randint(-127, 128, (L, B, S, hkv * hd), dtype=torch.int8,
                           generator=g, device=dev),
             torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.05]
    cache += [c.clone() for c in cache]
    x = torch.randn((B, cfg.hidden_dim), generator=g, device=dev).bfloat16()
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    slot = torch.zeros(B, dtype=torch.int32, device=dev)
    vfrom = torch.zeros(B, dtype=torch.int32, device=dev)
    graph_c = [c.clone() for c in cache]

    def step():
        return t_fd.fused_decode_step(blocks, x, *graph_c, slot, vfrom,
                                      cos[slot.long()], sin[slot.long()],
                                      cfg, slot=slot, write_cache=True)[0]

    captured = CapturedStep(step, dev)
    for at in (30, 31):
        for t, c in zip(graph_c, cache):
            t.copy_(c)
        slot.fill_(at)
        before = t_fd.launches
        got = captured().clone()
        assert t_fd.launches == before + 1
        eager_c = [c.clone() for c in cache]
        want = t_fd.fused_decode_step(blocks, x, *eager_c, slot, vfrom,
                                      cos[slot.long()], sin[slot.long()],
                                      cfg, slot=slot, write_cache=True)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for a, b in zip(graph_c, eager_c):
            assert torch.equal(a, b)
        assert not torch.equal(graph_c[0][:, :, at], cache[0][:, :, at])


@pytest.mark.parametrize("fused", [True, False])
def test_captured_decode_matches_the_eager_loop(dev, fused):
    """cached_generate's decode, replayed from its captured graph, against
    DecodeLoop stepped eagerly from the same prefill: identical greedy
    tokens, on the fused and the per-op path."""
    from physics_llm_inference_tpu_torch.ops.sampling import sample_token
    from physics_llm_inference_tpu_torch.runtime import generate as gen

    cfg = ModelConfig(vocab_size=512, hidden_dim=512, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_dim=768,
                      max_seq_len=256, fused_decode=fused)
    params = init_params_int8(_gen(dev, 5), cfg)
    prompts = [[3 + i] * (2 + 3 * i) for i in range(8)]
    steps = decode_step_cache()
    for _ in range(2):   # the second call replays the first one's graph
        out = cached_generate(params, cfg, prompts, 12, temperature=0.0,
                              kv_dtype=torch.int8, step_cache=steps)
    assert steps.stats() == {"compiled_shapes": 1, "hits": 1, "misses": 1}
    ids, lens = gen.pad_and_stack(prompts, device=dev)
    b, p = ids.shape
    loop = DecodeLoop(params, cfg, b, -(-(p + 12) // 128) * 128, torch.int8,
                      True, 0, False, (), 0, None)
    logits0, _, vfrom = gen._prefill(params, cfg, ids, lens,
                                     loop.cache.as_slice())
    loop.begin(sample_token(logits0, None, temperature=0.0), lens, vfrom, p,
               0.0, 1.0)
    for _ in range(12):
        loop.step()
    assert (loop.emitted[:, :12].cpu().numpy() == out.tokens).all()


def test_sampled_decode_is_captured_with_its_generator(dev):
    """Sampled cached_generate captures the loop's own generator into the
    graph and loads the caller's state into it: two callers' generators
    from the same seed, through one step cache, give the same tokens from
    one entry, end in the same state, and each replay draws anew (the
    steps' tokens are not all one draw)."""
    cfg = ModelConfig(vocab_size=512, hidden_dim=512, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_dim=768,
                      max_seq_len=256)
    params = init_params_int8(_gen(dev, 6), cfg)
    prompts = [[5 + i, 2] for i in range(8)]
    steps = decode_step_cache()
    outs, states = [], []
    for _ in range(2):
        gen = torch.Generator(device=dev).manual_seed(3)
        outs.append(cached_generate(params, cfg, prompts, 8, generator=gen,
                                    temperature=0.9, top_k=40, top_p=0.95,
                                    kv_dtype=torch.int8,
                                    step_cache=steps).tokens)
        states.append(gen.get_state())
    assert steps.stats() == {"compiled_shapes": 1, "hits": 1, "misses": 1}
    assert (outs[0] == outs[1]).all()
    assert torch.equal(*states)
    assert 0 <= int(outs[0].min()) and int(outs[0].max()) < 512
    assert len({tuple(col) for col in outs[0].T.tolist()}) > 1


