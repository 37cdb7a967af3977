"""MoE models through the port's serving engines, against the JAX package's
(the counterpart of tests/test_moe_serving.py, minus its TP test, which
waits for parallel serving).

Both packages get the same f32 MoE model (the port's weights carried from
the JAX ones), as it is or INT8-quantized, and the same requests. At
capacity factor 4.0 no (token, expert) pair is dropped, so routing does
not hang on an f32 ulp: greedy tokens, finish reasons and the dispatch
trace (and, paged, the radix hits) must be identical, with no tolerance.
The slot engine decodes every slot, parked ones included, and the paged
prefill chunk routes its padded rows: the port feeds the same rows in the
same order as the reference. At factor 1.25 (decode capacity 1) drops
happen and the invariant is each engine's determinism, as in the
reference's tests."""
import jax
import pytest

from physics_llm_inference_tpu.models import ModelConfig as JConfig
from physics_llm_inference_tpu.models import init_params as j_init
from physics_llm_inference_tpu.models import quantize_params_int8 as j_q8
from physics_llm_inference_tpu.serve import engine as j_engine
from physics_llm_inference_tpu.serve import paged_engine as j_paged
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models.config import \
    ModelConfig as TConfig
from physics_llm_inference_tpu_torch.serve import engine as t_engine
from physics_llm_inference_tpu_torch.serve import paged_engine as t_paged
from torch_parity import to_numpy

# tests/test_moe_serving.py's model
MOE = dict(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=4, intermediate_dim=128, max_seq_len=128,
           dtype="float32", num_experts=4, num_experts_per_tok=2,
           expert_capacity_factor=4.0)
PROMPTS = [[3, 5, 7, 9, 11], [2, 4, 6, 8], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3],
           [17] * 20]
SLOT = dict(num_slots=3, max_seq_len=64, decode_horizon=2,
            prompt_buckets=(16, 32))
PAGED = dict(num_blocks=32, block_size=8, max_batch=3,
             max_blocks_per_request=8, prompt_buckets=(16, 32),
             decode_horizon=2)


def _models(int8: bool, **kw):
    jcfg = JConfig(**dict(MOE, **kw))
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    if int8:
        jparams = j_q8(jparams)
    return (jcfg, TConfig(**dict(MOE, **kw)), jparams,
            params_from_jax(to_numpy(jparams), device="cpu"))


def _serve(eng, req_cls, waves=(PROMPTS,), max_tokens=6):
    """Each wave's requests submitted at once and run to the end."""
    eng.dispatch_trace = []
    res = []
    for prompts in waves:
        rids = [eng.submit_request(req_cls(
            prompt_tokens=p, max_tokens=max_tokens, temperature=0.0))
            for p in prompts]
        eng.run_until_done(rids)
        res += [eng.get_result(r) for r in rids]
    return dict(results=[(r.tokens, r.finish_reason) for r in res],
                trace=eng.dispatch_trace)


# name: (INT8 weights, engine config over SLOT or PAGED)
SLOT_CASES = {"fp32": (False, {}), "int8": (True, {}),
              "int8-kv-h8": (True, dict(kv_dtype="int8", decode_horizon=8)),
              "chunked": (False, dict(max_prefill_chunk=16,
                                      prompt_buckets=(8, 16))),
              "speculative-k4": (False, dict(speculative_k=4,
                                             decode_horizon=1))}
PAGED_CASES = {"fp32": (False, {}), "int8": (True, {}),
               "int8-kv-h1": (True, dict(kv_dtype="int8", decode_horizon=1)),
               "radix-bs4": (False, dict(block_size=4, max_batch=2,
                                         decode_horizon=1))}


@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_slot_engine_matches_jax_engine(case):
    int8, kw = SLOT_CASES[case]
    jcfg, tcfg, jparams, tparams = _models(int8)
    ec = dict(SLOT, **kw)
    want = _serve(j_engine.InferenceEngine(
        jparams, jcfg, j_engine.EngineConfig(**ec)),
        j_engine.GenerationRequest)
    got = _serve(t_engine.InferenceEngine(
        tparams, tcfg, t_engine.EngineConfig(**ec)),
        t_engine.GenerationRequest)
    assert got == want
    assert all(len(t) == 6 for t, _ in got["results"])


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_engine_matches_jax_engine(case):
    int8, kw = PAGED_CASES[case]
    jcfg, tcfg, jparams, tparams = _models(int8)
    pc = dict(PAGED, **kw)
    # the radix case repeats a prompt in a second wave, which reuses the
    # first wave's prefix
    waves = [PROMPTS, PROMPTS[4:]] if case == "radix-bs4" else [PROMPTS]
    jeng = j_paged.PagedInferenceEngine(jparams, jcfg,
                                        j_paged.PagedEngineConfig(**pc))
    teng = t_paged.PagedInferenceEngine(tparams, tcfg,
                                        t_paged.PagedEngineConfig(**pc))
    want = _serve(jeng, j_engine.GenerationRequest, waves)
    got = _serve(teng, t_engine.GenerationRequest, waves)
    assert got == want
    hits = teng.stats()["radix_hit_tokens"]
    assert hits == jeng.stats()["radix_hit_tokens"]
    if case == "radix-bs4":
        assert hits >= 16


def test_paged_engine_agrees_with_slot_engine():
    """tests/test_moe_serving.py's cross-engine check on the port: the same
    greedy tokens from both engines at factor 4.0."""
    _, tcfg, _, tparams = _models(True)
    slot = _serve(t_engine.InferenceEngine(
        tparams, tcfg, t_engine.EngineConfig(**SLOT)),
        t_engine.GenerationRequest)
    paged = _serve(t_paged.PagedInferenceEngine(
        tparams, tcfg, t_paged.PagedEngineConfig(**PAGED)),
        t_engine.GenerationRequest)
    assert slot["results"] == paged["results"]


def test_engines_serve_deterministically_under_capacity_pressure():
    """Factor 1.25: drops happen (decode capacity 1), requests complete
    with in-vocab tokens, and each engine gives the same tokens twice."""
    _, tcfg, _, tparams = _models(False, expert_capacity_factor=1.25)
    makers = (
        lambda: t_engine.InferenceEngine(
            tparams, tcfg, t_engine.EngineConfig(
                num_slots=4, max_seq_len=64, prompt_buckets=(8, 16, 32))),
        lambda: t_paged.PagedInferenceEngine(
            tparams, tcfg, t_paged.PagedEngineConfig(**dict(
                PAGED, max_batch=4, prompt_buckets=(8, 16, 32)))))
    for make in makers:
        first = _serve(make(), t_engine.GenerationRequest)
        assert _serve(make(), t_engine.GenerationRequest) == first
        for toks, reason in first["results"]:
            assert len(toks) == 6 and reason == "length"
            assert max(toks) < tcfg.vocab_size


# ------------------------------------------------- bench/moe.py on the CPU

TINY = ["--batch", "2", "--layers", "1", "--hidden", "512", "--experts",
        "4", "--expert-ff", "64", "--prompt", "8", "--decode", "4"]
DECODE_KEYS = {"metric", "value", "unit", "vs_all_expert_floor",
               "vs_active_expert_floor", "ttft_p50_ms", "total_params_b",
               "active_params_b"}


def test_bench_moe_counts_and_floors_are_the_scripts():
    """scripts/bench_moe.py's config from the same flags, and its
    parameter arithmetic (leaf sizes, a quantized leaf by its values) on
    the JAX tree equal to the port's on the converted tree."""
    import dataclasses

    import numpy as np

    from physics_llm_inference_tpu_torch.bench import moe as bench_moe

    args = bench_moe.parse_args(TINY)
    cfg = bench_moe.moe_config(args)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.num_experts,
            cfg.expert_capacity_factor) == (4, 4, 4, 1.25)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    jparams = j_q8(j_init(jax.random.PRNGKey(0), jcfg))
    total = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jparams, is_leaf=lambda x: hasattr(x, "shape")))
    expert_w = cfg.num_layers * 4 * 3 * cfg.hidden_dim * cfg.intermediate_dim
    got = bench_moe.param_counts(params_from_jax(to_numpy(jparams),
                                                 device="cpu"), cfg, 2)
    assert got == (total, total - expert_w + expert_w * 2 // 4)
    defaults = bench_moe.moe_config(bench_moe.parse_args([]))
    assert (defaults.hidden_dim, defaults.num_layers, defaults.num_heads,
            defaults.intermediate_dim, defaults.num_experts) == \
        (2048, 16, 16, 2816, 8)


@pytest.mark.parametrize("engine", [False, True], ids=["decode", "engine"])
def test_bench_moe_prints_the_scripts_line(engine, capsys):
    """One JSON line with the script's keys, at a toy size on the CPU
    with the H100's spec injected: no device number comes of it."""
    import json

    from physics_llm_inference_tpu_torch.bench import moe as bench_moe
    from physics_llm_inference_tpu_torch.specs.gpu import H100_SXM

    argv = TINY + (["--engine"] if engine else [])
    res = bench_moe.main(argv, device="cpu", spec=H100_SXM)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == res
    if engine:
        assert res["metric"] == "moe_serving_slot_engine"
        assert res["num_requests"] == 4
        assert round(res["tokens_per_s"] * res["total_time_s"]) == 16
        assert res["config"] == {"slots": 2, "prompt": 8, "decode": 4,
                                 "horizon": 8}
    else:
        assert set(res) == DECODE_KEYS and res["value"] > 0
        # the shares are rounded to 4 digits: a slow CPU reads 0.0
        assert res["vs_all_expert_floor"] <= res["vs_active_expert_floor"]
