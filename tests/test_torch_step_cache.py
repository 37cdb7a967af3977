"""The port's step cache (runtime/step_cache.py) against the JAX package's,
and its CPU side: on the CPU a step is the eager callable, and its static
inputs are filled by plain copies."""
import numpy as np
import torch

from physics_llm_inference_tpu.runtime.step_cache import StepCache as JCache
from physics_llm_inference_tpu_torch.runtime import step_cache as tsc

KEYS = [(16,), (32,), (16,), (64, 2), (16,), (64, 2), (32,), (128,)]


def test_step_cache_stats_match_jax_at_each_get():
    made_j, made_t = [], []
    jc = JCache(lambda *k: made_j.append(k) or ("step", k))
    tc = tsc.StepCache(lambda *k: made_t.append(k) or ("step", k))
    for key in KEYS:
        assert tc.get(*key) == jc.get(*key)
        assert tc.stats() == jc.stats()
    assert made_t == made_j
    assert tc.stats() == {"compiled_shapes": 4, "hits": 4, "misses": 4}


def test_staged_inputs_fill_static_buffers_on_cpu():
    ids = torch.zeros((2, 3), dtype=torch.int32)
    temps = torch.ones(2)
    inputs = tsc.StagedInputs("cpu", ids=ids, temps=temps)
    inputs.load(ids=np.arange(6, dtype=np.int32).reshape(2, 3),
                temps=np.array([0.5, 0.0], np.float32))
    # the same tensors, filled in place: a captured step reads them
    assert inputs.buffers["ids"] is ids and inputs.buffers["temps"] is temps
    assert ids.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert temps.tolist() == [0.5, 0.0]


def test_launch_counters_cover_every_kernel_module():
    """The counters a captured step moves on replay: every `*launches`
    integer of the kernel modules, those chip_smoke.py reads included."""
    names = {(m.__name__.rsplit(".", 1)[1], a)
             for m, a in tsc._launch_counters()}
    for want in [("fused_decode", "launches"),
                 ("fused_decode", "w4a16_launches"),
                 ("fused_decode", "w8a8_launches"),
                 ("fused_decode", "paged_launches"),
                 ("int8_matmul", "stream_launches"),
                 ("int8_matmul", "wgmma_launches"),
                 ("int8_kv_attention", "launches"), ("lmhead", "launches"),
                 ("flash_attention", "launches"),
                 ("paged_attention", "int8_paged_launches"),
                 ("paged_attention", "paged_launches")]:
        assert want in names, want
