"""The microbenchmark path of the port against the JAX package, on the CPU:
the roofline model (the JAX functions read the port's GPUSpec), the FFN
and GQA ops and naive_generate on the same numpy inputs and weights
(tolerances of torch_parity.TOL, greedy tokens identical), the static
batcher's copy, and the bench functions' result schemas at tiny sizes. A
CPU time is no device number: only the keys and the counts are checked."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.bench import micro as jmicro
from physics_llm_inference_tpu.bench import suite as jsuite
from physics_llm_inference_tpu.kernels import membench as jmem
from physics_llm_inference_tpu.models.config import ModelConfig as JConfig
from physics_llm_inference_tpu.models.transformer import init_params as j_init
from physics_llm_inference_tpu.ops import ffn as jffn
from physics_llm_inference_tpu.ops import gqa as jgqa
from physics_llm_inference_tpu.ops.rope import \
    rope_frequencies as j_rope_freqs
from physics_llm_inference_tpu.runtime.generate import \
    naive_generate as j_naive
from physics_llm_inference_tpu.sched import static_batcher as jsb
from physics_llm_inference_tpu.specs import roofline as jroof
from physics_llm_inference_tpu.utils.timing import benchmark_fn as j_bench_fn
from physics_llm_inference_tpu_torch.bench import micro as tmicro
from physics_llm_inference_tpu_torch.bench import suite as tsuite
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.kernels import membench as tmem
from physics_llm_inference_tpu_torch.models.config import ModelConfig as TConfig
from physics_llm_inference_tpu_torch.ops import ffn as tffn
from physics_llm_inference_tpu_torch.ops import gqa as tgqa
from physics_llm_inference_tpu_torch.ops.rope import \
    rope_frequencies as t_rope_freqs
from physics_llm_inference_tpu_torch.runtime.generate import (
    cached_generate, naive_generate)
from physics_llm_inference_tpu_torch.sched import static_batcher as tsb
from physics_llm_inference_tpu_torch.specs import gpu as tgpu
from physics_llm_inference_tpu_torch.specs import roofline as troof
from physics_llm_inference_tpu_torch.utils.timing import benchmark_fn
from torch_parity import TOL, assert_close, t2n, to_numpy

H100 = tgpu.H100_SXM


# ---- specs/roofline ----------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("arithmetic_intensity_gemm", (4096, 4096, 4096)),
    ("arithmetic_intensity_gemm", (64, 11008, 4096, "int8")),
    ("arithmetic_intensity_gemv", (4096, 4096, "fp32")),
    ("arithmetic_intensity_batched_gemv", (8, 4096, 4096)),
    ("dtype_bytes", ("fp8",)),
])
def test_intensity_matches_jax(name, args):
    assert getattr(troof, name)(*args) == getattr(jroof, name)(*args)


@pytest.mark.parametrize("dtype", ["bf16", "int8", "fp32"])
def test_roofline_on_the_gpu_spec_matches_jax(dtype):
    """The JAX functions read the port's GPUSpec as they read a TPUSpec."""
    assert troof.ridge_point(H100, dtype) == jroof.ridge_point(H100, dtype)
    for ai in (0.5, 10.0, troof.ridge_point(H100, dtype), 1e4):
        assert troof.roofline_throughput(ai, H100, dtype) == \
            jroof.roofline_throughput(ai, H100, dtype)
        assert troof.is_compute_bound(ai, H100, dtype) == \
            jroof.is_compute_bound(ai, H100, dtype)
    assert troof.find_transition_batch_size(4096, 4096, H100, dtype) == \
        jroof.find_transition_batch_size(4096, 4096, H100, dtype)


def test_h100_spec_values():
    """The H100 SXM data-sheet numbers: the bf16 ridge ~295 flop/byte."""
    assert H100.peak_int8_ops == 1979e12 and H100.fp32_tflops == 67.0
    assert H100.ridge_point("bf16") == pytest.approx(295.2, abs=0.1)
    assert troof.find_transition_batch_size(4096, 4096, H100) == 512
    with pytest.raises(ValueError):
        tgpu.get_gpu_spec("NVIDIA A100-SXM4-80GB")
    assert tgpu.get_gpu_spec("NVIDIA H100 80GB HBM3") is H100


def test_decode_lower_bound_matches_jax_and_the_floor():
    args = (7_000_000_000, 2_000_000_000, 64, H100)
    want = jroof.decode_step_time_lower_bound(*args)
    assert troof.decode_step_time_lower_bound(*args) == want
    assert tgpu.decode_step_floor_s(7_000_000_000, 2_000_000_000, H100) == want


# ---- ops/ffn, ops/gqa --------------------------------------------------------

def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1, s) * scale).astype(np.float32) for s in shapes]


def _both(fn_j, fn_t, *arrays, **kw):
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    return t2n(got), np.asarray(want)


@pytest.mark.parametrize("name", ["ffn_relu", "swiglu", "fused_swiglu"])
def test_ffn_matches_jax(name):
    d, f = 64, 96
    x, wg, wu, wd = _arrays(0, (2, 5, d), (d, f), (d, f), (f, d), scale=0.3)
    args = {"ffn_relu": (x, wu, wd), "swiglu": (x, wg, wu, wd),
            "fused_swiglu": (x, np.concatenate([wg, wu], axis=1), wd)}[name]
    got, want = _both(getattr(jffn, name), getattr(tffn, name), *args)
    assert_close(got, want, "float32")


def test_fused_swiglu_equals_swiglu():
    d, f = 64, 96
    x, wg, wu, wd = (torch.from_numpy(a) for a in
                     _arrays(1, (3, d), (d, f), (d, f), (f, d), scale=0.3))
    torch.testing.assert_close(tffn.fused_swiglu(x, torch.cat([wg, wu], 1), wd),
                               tffn.swiglu(x, wg, wu, wd), **TOL["float32"])


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("heads,kv_heads,causal", [(8, 2, True), (4, 4, True),
                                                   (8, 4, False)])
def test_gqa_attention_matches_jax(heads, kv_heads, causal, rope):
    d, s, hd = 64, 12, 16
    x, wq, wk, wv, wo = _arrays(2, (2, s, d), (d, heads * hd),
                                (d, kv_heads * hd), (d, kv_heads * hd),
                                (heads * hd, d), scale=0.3)
    jkw, tkw = {}, {}
    if rope:
        jc, js = j_rope_freqs(hd, 32)
        tc, ts = t_rope_freqs(hd, 32)
        jkw = dict(rope_cos=jc, rope_sin=js)
        tkw = dict(rope_cos=tc, rope_sin=ts)
    want = jgqa.gqa_attention(*(jnp.asarray(a) for a in (x, wq, wk, wv, wo)),
                              heads, kv_heads, causal=causal, **jkw)
    got = tgqa.gqa_attention(*(torch.from_numpy(a)
                               for a in (x, wq, wk, wv, wo)),
                             heads, kv_heads, causal=causal, **tkw)
    assert_close(t2n(got), want, "float32")


@pytest.mark.parametrize("hkv,hd,nbytes", [(8, 128, 2), (2, 64, 1)])
def test_kv_cache_bytes_per_token_matches_jax(hkv, hd, nbytes):
    assert tgqa.kv_cache_bytes_per_token(hkv, hd, nbytes) == \
        jgqa.kv_cache_bytes_per_token(hkv, hd, nbytes)


# ---- runtime/generate.naive_generate -----------------------------------------

TOY = dict(vocab_size=128, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_dim=128, max_seq_len=64,
           dtype="float32", attention_impl="dense")


def test_naive_generate_greedy_matches_jax_and_cached():
    jcfg, tcfg = JConfig(**TOY), TConfig(**TOY)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(to_numpy(jparams), device="cpu")
    prompt = np.array([[5, 17, 3, 42, 8, 11, 2, 9],
                       [1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    want = j_naive(jparams, jcfg, jnp.asarray(prompt), 8, temperature=0.0)
    got = naive_generate(tparams, tcfg, torch.from_numpy(prompt), 8,
                         temperature=0.0)
    assert got.shape == (2, 8) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    # the cache changes the cost, not the tokens
    cached = cached_generate(tparams, tcfg, prompt.tolist(), 8,
                             temperature=0.0)
    np.testing.assert_array_equal(got, cached.tokens)


def test_naive_generate_samples_from_the_generator():
    tcfg = TConfig(**TOY)
    tparams = params_from_jax(to_numpy(j_init(jax.random.PRNGKey(1),
                                              JConfig(**TOY))), device="cpu")
    ids = torch.ones((1, 4), dtype=torch.int64)
    runs = [naive_generate(tparams, tcfg, ids, 6,
                           generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].min() >= 0 and runs[0].max() < TOY["vocab_size"]


# ---- sched/static_batcher ----------------------------------------------------

@pytest.mark.parametrize("lens,batch", [([10, 2, 10, 2], 2),
                                        ([5, 9, 1, 7, 3], 2),
                                        ([4], 8)])
def test_static_batching_waste_matches_jax(lens, batch):
    assert tsb.analyze_static_batching_waste(lens, batch) == \
        jsb.analyze_static_batching_waste(lens, batch)


def test_static_batcher_matches_jax():
    jb, tb = jsb.StaticBatcher(3), tsb.StaticBatcher(3)
    for p in ([1, 2], [3], [4, 5, 6, 7], [8]):
        jb.add(p)
        tb.add(p)
    j1, t1 = jb.next_batch(), tb.next_batch()
    assert (t1.prompt_lens, t1.padded_len, t1.efficiency) == \
        (j1.prompt_lens, j1.padded_len, j1.efficiency)
    assert jb.next_batch() is None and tb.next_batch() is None


def test_suite_static_batching_waste_matches_jax():
    assert tsuite.static_batching_waste() == jsuite.static_batching_waste()


# ---- the bench functions at tiny sizes on the CPU: the JAX schema --------------

def test_benchmark_fn_schema_matches_jax():
    t = benchmark_fn(lambda x: x + 1, torch.ones((8, 8)), warmup=1, iters=3,
                     name="add")
    j = j_bench_fn(lambda x: x + 1, jnp.ones((8, 8)), warmup=1, iters=3,
                   name="add")
    assert t.iters == 3 and t.min_ms <= t.mean_ms <= t.max_ms
    assert t.to_dict().keys() == j.to_dict().keys()
    assert "add" in str(t)


def test_measure_access_patterns_schema_matches_jax():
    before = (tmem.stream_launches, tmem.strided_launches)
    got = tmem.measure_access_patterns(total_mb=2, stride=8, iters=2,
                                       device="cpu")
    want = jmem.measure_access_patterns(total_mb=2, stride=8, iters=2)
    assert got.keys() == want.keys() and got["stride"] == 8
    assert got["stream_gbps"] > 0 and got["strided_gbps"] > 0
    assert (tmem.stream_launches, tmem.strided_launches) == before


_J_DT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


@pytest.mark.parametrize("name,kw", [
    ("bench_gemm", dict(m=128, n=128, k=256, iters=1)),
    ("bench_gemm", dict(m=128, n=128, k=256, iters=1, use_kernel=True,
                        dtype=torch.float32)),
    ("bench_gemv", dict(batch=8, n=256, k=256, iters=1)),
    ("bench_gemv", dict(batch=8, n=256, k=256, iters=1, int8_weights=True)),
    ("bench_attention", dict(batch=1, heads=4, kv_heads=2, seq=128,
                             head_dim=64, iters=1, use_flash=False)),
    ("bench_attention", dict(batch=1, heads=4, kv_heads=2, seq=128,
                             head_dim=64, iters=1, use_flash=True)),
])
def test_bench_schema_matches_jax(name, kw):
    got = getattr(tmicro, name)(device="cpu", **kw)
    jkw = dict(kw, dtype=_J_DT[kw.get("dtype", torch.bfloat16)])
    want = getattr(jmicro, name)(**jkw)
    assert got.keys() == want.keys()
    assert got["mean_ms"] > 0 and got["arithmetic_intensity"] == \
        pytest.approx(want["arithmetic_intensity"], rel=1e-3)
    assert "% of roofline" in tmicro.roofline_report([got])


def test_bench_precision_schema_and_tf32_flag():
    flag = torch.backends.cuda.matmul.allow_tf32
    got = tmicro.bench_precision(size=128, iters=1, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 == flag
    assert got.keys() == jmicro.bench_precision(size=128, iters=1).keys()


@pytest.mark.parametrize("name,kw", [
    ("mha_vs_gqa", dict(dim=64, heads=8, seq=16, iters=1)),
    ("fused_vs_unfused", dict(dim=64, ff=96, seq=16, iters=1)),
    ("naive_vs_cached", dict(prompt_len=8, new_tokens=4)),
])
def test_suite_sections_schema_matches_jax(name, kw):
    got = getattr(tsuite, name)(device="cpu", **kw)
    want = getattr(jsuite, name)(**kw)
    assert got.keys() == want.keys()
    if name == "mha_vs_gqa":
        assert got["kv_reduction"] == want["kv_reduction"] == 4.0


def test_suite_runs_on_the_card_only(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tsuite.main(["--quick"])
