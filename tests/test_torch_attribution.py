"""bench/attribution, bench/probe_step_overhead and bench/probe_prefill
(the ports of bench/attribution.py and the two scripts): the weight and KV
bytes and the floors against the JAX module's arithmetic at a tiny config
(exact), the three parts and the probes' arms with their keys at a toy
size on the CPU, glue as the full step less the matmuls and attention."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physics_llm_inference_tpu.models import ModelConfig as JaxConfig
from physics_llm_inference_tpu.models import init_params as jax_init
from physics_llm_inference_tpu.models import quantize_params_int8 as jax_q8
from physics_llm_inference_tpu_torch.bench import (attribution,
                                                   probe_prefill,
                                                   probe_step_overhead)
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models.config import ModelConfig
from physics_llm_inference_tpu_torch.specs.gpu import H100_SXM
from torch_parity import to_numpy

TINY = dict(vocab_size=512, hidden_dim=128, num_layers=2, num_heads=2,
            num_kv_heads=1, intermediate_dim=256, max_seq_len=256)


@pytest.mark.parametrize("batch,cache_len", [(32, 256), (4, 48)])
def test_bytes_and_floors_are_the_jax_arithmetic(batch, cache_len):
    jcfg = JaxConfig(dtype="float32", **TINY)
    jp = jax_q8(jax_init(jax.random.PRNGKey(0), jcfg))
    # bench/attribution.py's sums over the JAX tree and arrays
    wbytes = sum(t.size for t in jax.tree_util.tree_leaves(jp["blocks"])
                 if t.dtype == jnp.int8) + jp["lm_head"].q.size
    L, hkv, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim
    kq = np.zeros((L, batch, cache_len, hkv * hd), np.int8)
    ks = np.zeros((L, batch, hkv, cache_len), np.float32)
    kv = 2 * (kq.nbytes + ks.nbytes)
    pp = params_from_jax(to_numpy(jp), device="cpu")
    assert attribution.weight_bytes(pp) == wbytes
    assert attribution.kv_bytes(ModelConfig(dtype="float32", **TINY), batch,
                                cache_len) == kv
    assert wbytes / H100_SXM.hbm_bandwidth == pytest.approx(
        wbytes / 3.35e12, rel=1e-12)


@pytest.fixture(scope="module")
def attributed():
    cfg = ModelConfig(dtype="float32", **TINY)
    return attribution.main(["--batch", "4", "--cache-len", "32",
                             "--steps", "2"], device="cpu", cfg=cfg,
                            spec=H100_SXM)


def test_attribution_keys_at_a_toy_size(attributed):
    r = attributed
    assert {"matmul_s", "matmul_floor_s", "matmul_eff", "attn_s",
            "attn_floor_s", "attn_eff", "glue_s", "sum_s", "weight_bytes",
            "kv_bytes", "full_s", "glue_alone_s"} <= set(r)
    for k in ("matmul_s", "attn_s", "full_s", "glue_alone_s"):
        assert r[k] > 0, k
    assert r["device"] == "cpu"
    cfg = ModelConfig(dtype="float32", **TINY)
    assert r["kv_bytes"] == attribution.kv_bytes(cfg, 4, 32)
    assert r["matmul_floor_s"] == r["weight_bytes"] / 3.35e12
    assert r["attn_eff"] == r["attn_floor_s"] / r["attn_s"]


def test_glue_is_the_full_step_less_matmuls_and_attention(attributed):
    r = attributed
    assert r["glue_s"] == pytest.approx(
        r["full_s"] - r["matmul_s"] - r["attn_s"], abs=1e-15)
    assert r["sum_s"] == pytest.approx(r["full_s"], abs=1e-15)


@pytest.mark.parametrize("best,runs", [(False, 4), (True, 3)])
def test_time_steps_counts_each_step_once(best, runs):
    calls = []
    t = attribution.time_steps(lambda: calls.append(1), 5, "cpu", repeats=3,
                               best=best)
    assert len(calls) == 5 * runs and t >= 0


def test_step_overhead_variants_at_a_toy_size():
    cfg = ModelConfig(dtype="float32", **dict(TINY, max_seq_len=64))
    out = probe_step_overhead.main(["--batch", "8", "--seq", "32",
                                    "--steps", "2", "--start", "8"],
                                   device="cpu", cfg=cfg)
    rows = out["ms_per_step"]
    assert list(rows) == ["kernel only", "+ norm/lm_head/argmax",
                          "+ head (K3)", "+ embed (K3)",
                          "full step (embed+sample)"]
    assert all(v > 0 for v in rows.values())
    m = out["marginal_ms"]
    assert m["head (K3)"] == rows["+ head (K3)"] - rows["kernel only"]
    assert m["outside the kernel (full step)"] == \
        rows["full step (embed+sample)"] - rows["kernel only"]
    with pytest.raises(ValueError):
        probe_step_overhead.main(["--seq", "32", "--start", "31"],
                                 device="cpu", cfg=cfg)


def test_prefill_arms_at_a_toy_size():
    cfg = ModelConfig(dtype="float32", **TINY)
    out = probe_prefill.main(["--batch", "2", "--prompt", "16",
                              "--layers", "2"], device="cpu", cfg=cfg,
                             spec=H100_SXM)
    for arm in ("full", "int8", "k1", "bf16"):
        assert out[arm]["ms"] > 0 and out[arm]["tflops"] > 0, arm
    fl = out["flops"]
    # scripts/probe_prefill.py's counts at these shapes
    T, D, F_, QO = 2 * 16, 128, 256, (2 + 2 * 1) * 64
    assert fl["matmul"] == 2 * T * 2 * (D * QO + 128 * D + 2 * D * F_
                                        + F_ * D)
    assert fl["attention"] == 2 * 2 * 2 * 2 * 16 * 16 * 64 * 2
    assert out["floor_ms"] == fl["matmul"] / 989e12 * 1e3
    assert out["rest_ms"] == pytest.approx(out["full"]["ms"]
                                           - out["int8"]["ms"])
    part = probe_prefill.main(["--batch", "2", "--prompt", "16",
                               "--layers", "2", "--arms", "bf16"],
                              device="cpu", cfg=cfg, spec=H100_SXM)
    assert part["full"] is None and part["bf16"] is not None
