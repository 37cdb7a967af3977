"""The port's online softmax, attention ops and their accounting, the
KVCache extras, and the occupancy model.

Against the JAX package on the same numpy inputs: f32 outputs within 1e-6
(softmax) and 1e-5 (attention; the order of f32 sums), bf16 outputs within
tests/torch_parity.py's bf16 tolerance; the accounting's integers equal.
The occupancy model against H100 cases computed by hand from its rules.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.models import config as jcfg_mod
from physics_llm_inference_tpu.ops import attention as jatt
from physics_llm_inference_tpu.ops import softmax as jsm
from physics_llm_inference_tpu.runtime.kv_cache import KVCache as JKVCache
from physics_llm_inference_tpu_torch.models import config as tcfg_mod
from physics_llm_inference_tpu_torch.ops import attention as tatt
from physics_llm_inference_tpu_torch.ops import softmax as tsm
from physics_llm_inference_tpu_torch.runtime.kv_cache import \
    KVCache as TKVCache
from physics_llm_inference_tpu_torch.specs import occupancy as occ
from physics_llm_inference_tpu_torch.specs.gpu import H100_SXM
from torch_parity import assert_close, t2n


def rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ online softmax

@pytest.mark.parametrize("shape,chunk", [((3, 300), 128), ((2, 4, 129), 7),
                                         ((5,), 128)])
def test_online_softmax_matches_reference(shape, chunk):
    x = rand(0, *shape) * 4
    want = np.asarray(jsm.online_softmax(jnp.asarray(x), chunk))
    got = t2n(tsm.online_softmax(torch.from_numpy(x), chunk))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, t2n(torch.softmax(torch.from_numpy(x),
                                                      -1)), atol=1e-6)


@pytest.mark.parametrize("n,chunk", [(300, 128), (64, 64), (10, 3)])
def test_online_softmax_with_output_matches_reference(n, chunk):
    s, v = rand(1, 2, 3, n) * 3, rand(2, n, 16)
    want = np.asarray(jsm.online_softmax_with_output(jnp.asarray(s),
                                                     jnp.asarray(v), chunk))
    got = t2n(tsm.online_softmax_with_output(torch.from_numpy(s),
                                             torch.from_numpy(v), chunk))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------- attention ops

def qkv(seed, b=2, h=3, sq=9, sk=9, d=16):
    return rand(seed, b, h, sq, d), rand(seed + 1, b, h, sk, d), \
        rand(seed + 2, b, h, sk, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["naive", "causal", "causal_offset"])
def test_attention_matches_reference(dtype, case):
    sq = 4 if case == "causal_offset" else 9
    q, k, v = qkv(3, sq=sq, sk=9)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq_, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    tq_, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    if case == "naive":
        want, got = jatt.naive_attention(jq_, jk, jv), \
            tatt.naive_attention(tq_, tk, tv)
    else:
        off = 5 if case == "causal_offset" else 0
        want = jatt.causal_attention(jq_, jk, jv, offset=off)
        got = tatt.causal_attention(tq_, tk, tv, offset=off)
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    else:
        assert_close(t2n(got), np.asarray(want, np.float32), dtype)


def test_multi_head_attention_matches_reference():
    x = rand(7, 2, 6, 32)
    w = [rand(8 + i, 32, 32) * 0.2 for i in range(4)]
    for causal in (True, False):
        want = jatt.multi_head_attention(jnp.asarray(x),
                                         *map(jnp.asarray, w), 4,
                                         causal=causal)
        got = tatt.multi_head_attention(torch.from_numpy(x),
                                        *map(torch.from_numpy, w), 4,
                                        causal=causal)
        np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("b,h,s,d", [(1, 32, 1024, 128), (4, 8, 4096, 64),
                                     (2, 1, 1 << 20, 128), (3, 7, 33, 17)])
def test_attention_accounting_integers_equal(b, h, s, d):
    assert tatt.attention_flops(b, h, s, d) == jatt.attention_flops(b, h, s, d)
    for nbytes in (1, 2, 4):
        assert tatt.attention_memory_bytes(b, h, s, d, nbytes) == \
            jatt.attention_memory_bytes(b, h, s, d, nbytes)
        assert tatt.attention_arithmetic_intensity(b, h, s, d, nbytes) == \
            jatt.attention_arithmetic_intensity(b, h, s, d, nbytes)
    for budget in (1 << 20, 80 << 30):
        for flash in (False, True):
            assert tatt.max_attendable_seq(budget, b, h, d, flash=flash) == \
                jatt.max_attendable_seq(budget, b, h, d, flash=flash)


def test_probe_attention_memory_on_cpu_matches_reference():
    kw = dict(batch=1, heads=2, head_dim=16, start_seq=16, max_seq=64)
    want = jatt.probe_attention_memory(**kw)
    got = tatt.probe_attention_memory(device="cpu", **kw)
    assert got == want
    flash = tatt.probe_attention_memory(device="cpu", flash=True, **kw)
    assert flash["max_ok"] == 64 and flash["results"][-1][
        "predicted_bytes"] == tatt.attention_memory_bytes(
            1, 2, 64, 16)["qkvo_bytes"]


def test_probe_stops_only_at_out_of_memory(monkeypatch):
    """The sweep's boundary is torch.cuda.OutOfMemoryError; a failed launch
    (any other error) propagates instead of reading as a boundary."""
    def oom_from_64(q, k, v):
        if q.shape[-2] >= 64:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return q

    monkeypatch.setattr(tatt, "causal_attention", oom_from_64)
    res = tatt.probe_attention_memory(heads=1, head_dim=8, start_seq=16,
                                      max_seq=256, device="cpu")
    assert res["failed_at"] == 64 and res["max_ok"] == 32
    assert res["results"][-1] == {"seq": 64, "ok": False,
                                  "error": "OutOfMemoryError"}

    def launch_fails(q, k, v):
        raise RuntimeError("CUDA error: invalid configuration argument")

    monkeypatch.setattr(tatt, "causal_attention", launch_fails)
    with pytest.raises(RuntimeError, match="invalid configuration"):
        tatt.probe_attention_memory(heads=1, head_dim=8, start_seq=16,
                                    max_seq=32, device="cpu")


# ------------------------------------------------------- the KVCache extras

@pytest.mark.parametrize("dtype", [None, "int8"])
def test_kv_cache_extras_match_reference(dtype):
    shape = dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=4,
                 num_kv_heads=2, intermediate_dim=48, dtype="float32")
    jc = JKVCache.create(jcfg_mod.ModelConfig(**shape), 3, 40,
                         dtype=jnp.int8 if dtype else None)
    tc = TKVCache.create(tcfg_mod.ModelConfig(**shape), 3, 40,
                         dtype=torch.int8 if dtype else None, device="cpu")
    assert tc.max_seq_len == jc.max_seq_len == 40
    assert tc.memory_bytes() == jc.memory_bytes()
    back = TKVCache.from_slice(tc.as_slice()._replace(start=7))
    assert back.length == 7 and back.k is tc.k and back.v is tc.v
    assert JKVCache.from_slice(jc.as_slice()._replace(start=7)).length == 7


# ------------------------------------------------------- the occupancy model

@pytest.mark.parametrize("threads,regs,smem,blocks,limit", [
    # 8 warps x 128 registers = 32,768 a block: two blocks fill 65,536
    (256, 128, 0, 2, "registers"),
    # K7's bf16 rows: 70 KB + 1 KB reserved = 72,704 bytes; 233,472 // that
    (128, 40, 70 * 1024, 3, "shared_memory"),
    # 1,024 threads a block: 2,048 // 1,024
    (1024, 32, 0, 2, "threads"),
    # one warp of 16 registers: the cap of 32 resident blocks binds
    (32, 16, 0, 32, "blocks"),
    # 33 registers round to 40 a thread (1,280 a warp): 65,536 // 1,280 = 51
    # warps, // 4 warps a block = 12 blocks; threads alone would allow 16
    (128, 33, 0, 12, "registers"),
    # a whole block's worth of shared memory: one block
    (384, 168, 227 * 1024, 1, "registers"),
    (64, 32, 227 * 1024, 1, "shared_memory"),
    # 48 KB + 100 bytes rounds to 49,280 + 1,024 reserved: 233,472 // 50,304
    (128, 32, 48 * 1024 + 100, 4, "shared_memory"),
])
def test_max_resident_blocks_hand_cases(threads, regs, smem, blocks, limit):
    assert occ.max_resident_blocks(threads, regs, smem, H100_SXM) == \
        (blocks, limit)


def test_occupancy_fraction_and_limits():
    o = occ.occupancy(256, 128, 0)
    assert o == {"blocks_per_sm": 2, "warps_per_sm": 16, "occupancy": 0.25,
                 "limit": "registers",
                 "limits": {"blocks": 32, "threads": 8, "registers": 2,
                            "shared_memory": 228}}
    assert occ.occupancy(64, 32, 0)["occupancy"] == 1.0


@pytest.mark.parametrize("threads,regs,smem", [
    (1025, 32, 0), (0, 32, 0), (128, 256, 0), (128, 32, 227 * 1024 + 1),
    (1024, 72, 0)])   # 72 x 1,024 registers > 65,536: the launch fails
def test_refused_launches_raise(threads, regs, smem):
    with pytest.raises(ValueError):
        occ.max_resident_blocks(threads, regs, smem)


def test_h100_spec_limits():
    s = H100_SXM
    assert (s.sm_count, s.regs_per_sm, s.smem_per_sm, s.smem_per_block,
            s.threads_per_sm, s.blocks_per_sm) == (132, 65536, 233472,
                                                   232448, 2048, 32)
