"""The port's flash attention (kernels/flash_attention.py) and prefill linear
against the JAX package: the Pallas flash kernel in interpret mode, JAX
`_prefill` with flash attention, and the XLA expression of the JAX
`_linear` at prefill sizes. On the CPU the port's entry points take their
plain versions; the CUDA kernel is held against them on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.kernels.flash_attention import \
    flash_attention as j_flash
from physics_llm_inference_tpu.models import config as jcfg_mod
from physics_llm_inference_tpu.models.quant import quantize_params_int8
from physics_llm_inference_tpu.models.transformer import init_params
from physics_llm_inference_tpu.runtime import generate as jgen
from physics_llm_inference_tpu.runtime.kv_cache import KVCache as JKVCache
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.kernels import flash_attention as t_fa
from physics_llm_inference_tpu_torch.models import config as tcfg_mod
from physics_llm_inference_tpu_torch.models import transformer as ttf
from physics_llm_inference_tpu_torch.models.quant import QuantizedTensor
from physics_llm_inference_tpu_torch.runtime import generate as tgen
from physics_llm_inference_tpu_torch.runtime.kv_cache import KVCache as TKVCache
from torch_parity import assert_close, t2n, to_numpy


def _bf16(rng, shape):
    a = rng.normal(0, 1, shape).astype(np.float32)
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("case", [
    # (B, Hq, Hkv, Sq, Sk, q_offset, kv_len, valid_from)
    (2, 8, 2, 64, 64, 0, None, None),            # square causal GQA
    (3, 4, 4, 48, 80, [32, 10, 0], None, [0, 3, 9]),  # rectangular, ragged
    (2, 8, 1, 40, 96, [56, 20], 90, [5, 0]),     # MQA, kv_len < Sk
])
def test_flash_matches_pallas(case):
    b, hq, hkv, sq, sk, qoff, kv_len, vfrom = case
    d = 64
    rng = np.random.default_rng(sq + sk)
    q, k, v = (_bf16(rng, s) for s in ((b, hq, sq, d), (b, hkv, sk, d),
                                       (b, hkv, sk, d)))
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    joff = 0 if qoff == 0 else jnp.asarray(qoff, jnp.int32)
    jv = None if vfrom is None else jnp.asarray(vfrom, jnp.int32)
    want = np.asarray(j_flash(*jargs, q_offset=joff, causal=True,
                              kv_len=kv_len, valid_from=jv, interpret=True),
                      np.float32)
    targs = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got = t2n(t_fa.flash_attention(
        *targs, q_offset=0 if qoff == 0 else torch.tensor(qoff),
        causal=True, kv_len=kv_len,
        valid_from=None if vfrom is None else torch.tensor(vfrom)))
    assert got.shape == (b, hq, sq, d) and np.isfinite(got).all()
    # live rows: a query at or past valid_from. Rows left of it are left
    # padding with no live key; both kernels give them an average over
    # masked keys, which no live row reads, so only finiteness is required
    qpos = np.asarray(qoff if qoff != 0 else [0] * b)[:, None] + np.arange(sq)
    live = qpos >= np.asarray(vfrom if vfrom is not None else [0] * b)[:, None]
    # one bf16 ulp of an output ~1 plus the bf16 probabilities' rounding
    np.testing.assert_allclose(got.transpose(0, 2, 1, 3)[live],
                               want.transpose(0, 2, 1, 3)[live], atol=2e-2,
                               rtol=0)
    assert t_fa.launches == 0  # the CPU path launches no kernel


def test_prefill_through_flash_matches_jax():
    """JAX `_prefill` against the port's with attention_impl="flash" on a
    small bf16 model: ragged left-padded prompts, the fresh-KV branch."""
    slice_cfg = dict(vocab_size=512, hidden_dim=256, num_layers=2,
                     num_heads=4, num_kv_heads=2, intermediate_dim=512,
                     max_seq_len=128, dtype="bfloat16",
                     attention_impl="flash")
    jcfg = jcfg_mod.ModelConfig(**slice_cfg)
    tcfg = tcfg_mod.ModelConfig(**slice_cfg)
    jparams = quantize_params_int8(init_params(jax.random.PRNGKey(0), jcfg))
    tparams = params_from_jax(to_numpy(jparams), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 512, n)) for n in (9, 30, 32)]
    jids, jlens = jgen.pad_and_stack(prompts)
    tids, tlens = tgen.pad_and_stack(prompts)
    b, p = jids.shape
    jcache = JKVCache.create(jcfg, b, p + 8, dtype=jnp.int8)
    tcache = TKVCache.create(tcfg, b, p + 8, dtype=torch.int8)
    jl, _, _ = jgen._prefill(jparams, jcfg, jids, jlens, jcache.as_slice())
    tl, _, _ = tgen._prefill(tparams, tcfg, tids, tlens, tcache.as_slice())
    assert tl.shape == jl.shape
    assert_close(t2n(tl), jl, "bfloat16")
    assert t_fa.launches == 0


def test_prefill_linear_matches_jax_expression():
    """The prefill linear's f32 product (`_linear_f32`) at m = 2048 against
    the JAX `_linear` XLA branch (transformer.py:141-143) before its cast:
    bf16 x times bf16(q), f32 accumulation, the scale after the dot."""
    m, k, n = 2048, 256, 192
    rng = np.random.default_rng(4)
    x = _bf16(rng, (m, k))
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = rng.uniform(1e-3, 1e-2, (1, n)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    acc = jnp.dot(jx, jnp.asarray(wq).astype(jx.dtype),
                  preferred_element_type=jnp.float32)
    want = np.asarray(acc * jnp.asarray(s))
    got = t2n(ttf._linear_f32(torch.from_numpy(x).bfloat16(),
                              QuantizedTensor(torch.from_numpy(wq),
                                              torch.from_numpy(s))))
    rel = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    assert rel.max() < 1e-5
