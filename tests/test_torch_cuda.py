"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where torch sees no CUDA device. This file
imports no jax, so on a machine without it run it as
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
"""
import pytest
import torch

from physics_llm_inference_tpu_torch.kernels import int8_kv_attention as t_attn
from physics_llm_inference_tpu_torch.kernels import int8_matmul as t_mm
from physics_llm_inference_tpu_torch.kernels import lmhead as t_head
from physics_llm_inference_tpu_torch.models import transformer as ttf
from physics_llm_inference_tpu_torch.models.config import ModelConfig
from physics_llm_inference_tpu_torch.models.quant import init_params_int8
from physics_llm_inference_tpu_torch.ops.norms import rms_norm
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
    cfg = ModelConfig(vocab_size=512, hidden_dim=256, num_layers=1,
                      num_heads=2, num_kv_heads=1, intermediate_dim=256)
    params = init_params_int8(_gen(dev), cfg)
    cache = KVCache.create(cfg, 8, 16, dtype=torch.int8, device=dev)
    ids = torch.ones((8, 1), dtype=torch.int64, device=dev)
    with pytest.raises(NotImplementedError, match="fused"):
        ttf.forward(params, ids, cfg, kv=cache.as_slice(), greedy_head=True)
