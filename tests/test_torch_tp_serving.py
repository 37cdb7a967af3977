"""The port's engines served tensor-parallel against the JAX package's on
the same mesh shapes (tests/test_tp_serving.py runs the JAX side alone).

The port side runs in four spawned gloo processes (tests/torch_dist_workers
.py, which imports no jax), one engine a rank: the slot engine over
data 2 x model 2, the paged engine over model 4, each with fp32 weights and
pool, and with INT8 weights and an INT8 pool. The JAX side runs its engines
on the same mesh shapes of the virtual 8-device CPU mesh. fp32 weights:
greedy tokens, finish reasons and dispatch_trace identical on every rank
and to JAX's; a sampled run is the same on every rank; radix reuse holds
under TP. One spawned world serves every test of the file.
"""
import jax
import numpy as np
import pytest

import torch_dist_workers as workers
from physics_llm_inference_tpu.models import (ModelConfig, init_params,
                                              quantize_params_int8)
from physics_llm_inference_tpu.parallel import make_mesh
from physics_llm_inference_tpu.serve.engine import (EngineConfig,
                                                    GenerationRequest,
                                                    InferenceEngine)
from physics_llm_inference_tpu.serve.paged_engine import (PagedEngineConfig,
                                                          PagedInferenceEngine)
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models.config import \
    ModelConfig as TModelConfig
from torch_parity import to_numpy

CFG = dict(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=8,
           num_kv_heads=4, intermediate_dim=128, max_seq_len=128,
           dtype="float32")
PROMPTS = [[3, 5, 7, 9, 11], [2, 4, 6, 8], [1, 2, 3],
           [10, 20, 30, 40, 50, 60], list(range(40, 58))]
SLOT = dict(num_slots=4, max_seq_len=64, decode_horizon=4,
            prompt_buckets=(16, 32))
PAGED = dict(num_blocks=32, block_size=8, max_batch=4,
             max_blocks_per_request=8, prompt_buckets=(16, 32),
             decode_horizon=2)
RADIX = dict(num_blocks=32, block_size=4, max_batch=2,
             max_blocks_per_request=8, prompt_buckets=(16,),
             decode_horizon=1)
RADIX_PROMPT = [7, 7, 7, 7, 9, 9, 9, 9, 3]


class _JaxEngine:
    """A JAX engine under engine_run's calls."""
    request_type = GenerationRequest

    def __init__(self, eng):
        self.eng = eng

    def __getattr__(self, name):
        return getattr(self.eng, name)

    def __setattr__(self, name, value):
        if name == "eng":
            object.__setattr__(self, name, value)
        else:
            setattr(self.eng, name, value)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = ModelConfig(**CFG)
    params = init_params(jax.random.PRNGKey(0), cfg)
    qparams = quantize_params_int8(params)
    # the port's ranks run while the JAX engines below run here
    world = workers.World(
        "tp_serving", 4, tmp_path_factory.mktemp("tp"),
        params_from_jax(to_numpy(params), device="cpu"),
        params_from_jax(to_numpy(qparams), device="cpu"), TModelConfig(**CFG),
        PROMPTS, SLOT, PAGED, RADIX, RADIX_PROMPT)
    ref = {}
    for name, p, kv in (("fp32", params, None), ("int8", qparams, "int8")):
        eng = InferenceEngine(p, cfg, EngineConfig(**SLOT, kv_dtype=kv),
                              mesh=make_mesh(data=2, model=2))
        ref[f"slot_{name}"] = workers.engine_run(_JaxEngine(eng), PROMPTS, 8)
        peng = PagedInferenceEngine(
            p, cfg, PagedEngineConfig(**PAGED, kv_dtype=kv),
            mesh=make_mesh(data=1, model=4))
        ref[f"paged_{name}"] = workers.engine_run(_JaxEngine(peng), PROMPTS, 8)
    return ref, world.results()


@pytest.mark.parametrize("engine", ["slot", "paged"])
@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_greedy_parity_with_jax(runs, engine, weights):
    ref, got = runs
    key = f"{engine}_{weights}"
    for rank, out in enumerate(got):
        tokens, reasons, trace = out[key]
        assert trace == ref[key][2], f"rank {rank}: dispatch_trace"
        assert reasons == ref[key][1], f"rank {rank}: finish reasons"
        assert tokens == ref[key][0], f"rank {rank}: tokens"


def test_mesh_coordinates_and_local_pool(runs):
    _, got = runs
    dm = [out["coords"][0] for out in got]
    assert dm == [{"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    assert [out["coords"][1] for out in got] == [
        {"data": 0, "model": m} for m in range(4)]
    # (L, slots / data, S, Hkv·hd / model)
    hd = CFG["hidden_dim"] // CFG["num_heads"]
    assert got[0]["slot_int8_pool"] == (
        CFG["num_layers"], 2, SLOT["max_seq_len"],
        CFG["num_kv_heads"] * hd // 2)


def test_sampled_run_is_rank_consistent(runs):
    _, got = runs
    first = got[0]["sampled"]
    assert all(len(t) == 6 for t in first[0])
    assert all(0 <= t < CFG["vocab_size"] for t in first[0][0])
    for out in got[1:]:
        assert out["sampled"] == first


def test_radix_reuse_under_tp(runs):
    _, got = runs
    for out in got:
        assert out["radix"][0] == out["radix"][1]
        assert out["radix_hits"] >= 8
