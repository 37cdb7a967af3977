"""DeepSeek-V2 brought as files (configs/deepseek-v2-lite.json,
arch/deepseek_v2.py, its mix, cell and readers): the configuration holds
the catalog row's keys at their published values; a toy of the same
architecture runs end to end on the CPU with the port's plain kernels and
is correct, its control and a planted fault are not; `Work` counts by
hand; the readers find the traced batch's phases by the program's spans."""
import json
import time
import types
from pathlib import Path

import pytest
import torch

from benchmark import run as bench
from benchmark.arch import deepseek_v2 as ds
from benchmark.lib.spec import metric_reader
from benchmark.lib.trace import Slice
from benchmark.tests import toy
from physics_llm_inference_tpu_torch.utils import tracing

REPO = Path(__file__).resolve().parent.parent.parent
PEAKS = {"bf16_flops": 1e15, "int8_ops": 2e15, "hbm_bytes_s": 1e12}
# every matrix's rows divisible by 64, the dense layer's W_down's (192) not
# by 128, as DeepSeek-V2-Lite's (10,944)
TOY = {"model_type": "deepseek_v2", "hidden_size": 128,
       "num_hidden_layers": 3, "num_attention_heads": 4,
       "num_key_value_heads": 4, "kv_lora_rank": 64,
       "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "v_head_dim": 16,
       "intermediate_size": 192, "moe_intermediate_size": 64,
       "n_routed_experts": 8, "n_shared_experts": 1,
       "num_experts_per_tok": 3, "first_k_dense_replace": 1,
       "norm_topk_prob": False, "routed_scaling_factor": 1.0,
       "rms_norm_eps": 1e-6, "rope_theta": 10000,
       "rope_scaling": {"type": "yarn", "factor": 40, "beta_fast": 32,
                        "beta_slow": 1, "mscale": 0.707,
                        "mscale_all_dim": 0.707,
                        "original_max_position_embeddings": 4096},
       "vocab_size": 512, "max_position_embeddings": 4096,
       "precision": {"weights": "int8", "kv_cache": "int8",
                     "activations": "bfloat16"},
       "assumed": {"expert_capacity_factor": 2.7}}
CELL = "toy_ds.decode"
NEW_METRICS = ["mla_decode_roofline", "mla_prefill_roofline",
               "expert_stream_roofline", "expert_rows_max_over_mean.prefill"]


def test_the_configuration_is_the_catalogs_row():
    cfg = json.loads((REPO / "benchmark" / "configs" /
                      "deepseek-v2-lite.json").read_text())
    row = {"num_hidden_layers": 27, "hidden_size": 2048,
           "n_routed_experts": 64, "n_shared_experts": 2,
           "num_experts_per_tok": 6, "kv_lora_rank": 512,
           "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
           "v_head_dim": 128, "moe_intermediate_size": 1408,
           "intermediate_size": 10944, "vocab_size": 102400,
           "max_position_embeddings": 163840, "norm_topk_prob": False,
           "first_k_dense_replace": 1, "q_lora_rank": None,
           "model_type": "deepseek_v2"}
    assert {k: cfg[k] for k in row} == row and cfg["reduced"] == {}
    assert cfg["rope_scaling"]["factor"] == 40
    # the capacity factor admits every pair of a 64-row decode step
    model = ds.model_config(cfg)
    assert int(model.expert_capacity_factor * 64 * 6 / 64) == 64


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = toy.make_root(tmp_path_factory.mktemp("ds"))
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "toy_ds", "source": "a test", "reduced": [],
                         "file": "benchmark/configs/toy_ds.json"})
    s["workloads"].append({"name": CELL, "config": "toy_ds",
                           "traffic": "toy_offline", "chips": 1,
                           "why": "a test"})
    s["end_to_end"][0]["workloads"].append(CELL)
    for m in s["per_layer"][:2]:
        m["workloads"].append(CELL)
    s["per_layer"] += [{"name": n, "unit": "%", "better": "higher",
                        "source": "device_trace", "layer": "kernels",
                        "moves": "output_tok_s", "workloads": [CELL]}
                       for n in NEW_METRICS]
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    (root / "benchmark" / "configs" / "toy_ds.json").write_text(
        json.dumps(TOY))
    (root / "benchmark" / "cells" / f"{CELL}.json").write_text(json.dumps(
        {"limits": {"logit_gap_max": toy.LIMIT,
                    "logit_gap_mean": toy.MEAN_LIMIT}}))
    return root


def _run(root, trace=False, control=False, seed=2**31 + 7):
    return bench.run_cell(root, CELL, seed, 1.5, trace, "cpu",
                          started=time.time(), control=control)


def test_a_toy_deepseek_cell_runs_and_is_correct(root):
    res = _run(root, control=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and "output_tok_s" in res["metrics"]
    # the control (int4 weights) reads above the limits
    assert res["checks"]["control.logit_gap_mean"]["value"] > \
        toy.MEAN_LIMIT, res["checks"]


def test_a_traced_toy_run_reads_the_prefill_route(root):
    res = _run(root, trace=True)
    assert res["correct"], res["checks"]
    ratio = res["metrics"]["expert_rows_max_over_mean.prefill"]["value"]
    assert ratio >= 1.0
    # no device: the device-trace readers read nothing, and do not raise
    for name in NEW_METRICS[:3]:
        assert name not in res["metrics"]


def test_a_token_altered_is_not_correct(root, monkeypatch):
    from physics_llm_inference_tpu_torch.runtime import generate

    real = generate.cached_generate

    def altered(*a, **kw):
        out = real(*a, **kw)
        out.tokens[:, 2] = (out.tokens[:, 2] + 1) % TOY["vocab_size"]
        return out
    monkeypatch.setattr(generate, "cached_generate", altered)
    assert not _run(root)["correct"]


def test_the_int4_control_regroups_rows_128_does_not_divide():
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-127, 128, (192, 8), dtype=torch.int8, generator=g)
    s = torch.rand((1, 8), generator=g) * 0.01
    w = {"m.q": q, "m.s": s}
    got = ds._dequant(w, "m", (), True)
    x = (q.float() * s).reshape(3, 64, 8)
    scale = x.abs().amax(dim=1, keepdim=True) / 7.0
    want = (torch.round(x / scale).clamp(-8, 7) * scale).reshape(192, 8)
    assert torch.equal(got, want)
    assert torch.equal(ds._dequant(w, "m", (), False), q.float() * s)


def _work():
    wb = {"attn_layer": 1000.0, "dense_layer": 5000.0, "moe_layer": 300.0,
          "expert_layer": 6400.0, "lm_head": 700.0, "norm": 8.0,
          "embed_row": 4.0}
    return ds.Work(TOY, wb)


def test_work_by_hand():
    w = _work()
    # 8 experts top-3: at 4 rows an expert goes unrouted with odds
    # (5/8)^4; at 64 rows never (8 (5/8)^64 < 1e-3)
    assert w.experts_touched(4) == pytest.approx(8 * (1 - (5 / 8) ** 4))
    assert w.experts_touched(64) == 8
    assert w.expert_bytes(64) == 6400.0
    # DeepSeek-V2-Lite's 64 experts top-6 at 64 rows: the expectation
    lite = ds.Work(json.loads((REPO / "benchmark" / "configs" /
                               "deepseek-v2-lite.json").read_text()),
                   {"expert_layer": 1.0})
    assert lite.experts_touched(64) == pytest.approx(
        64 * (1 - (58 / 64) ** 64))
    assert 63.8 < lite.experts_touched(64) < 63.9
    assert lite.kv_bytes == 584 and lite.moe_layers == 26
    # the latent cache read by the MLA kernel: 88 bytes a key here
    # (64 + 16 codes and two scales), queries and outputs bf16
    assert w.kv_bytes == 88
    per_layer = 88 * (3 + 5 + 2) + 2 * 4 * (2 * 80 + 2 * 64)
    assert w.mla_decode_bytes([3, 5]) == 3 * per_layer
    # decompressed prefill: pairs of a 4-token chunk 10, 2 x heads x (16 +
    # 16 + 16) a pair and layer
    assert w.mla_prefill_flops([(0, 4)]) == 2.0 * 3 * 10 * 4 * 48
    flops, nbytes = w.decode([3, 5])
    assert nbytes == (3 * 1000 + 5000 + 2 * (300 + w.expert_bytes(2))
                      + 700 + 8 + 2 * 4 + 3 * 88 * 10)
    assert flops > w.mla_decode_flops([3, 5]) > 0


def _traced(ops, spans, steps=2, lens=(3, 5)):
    """A run whose traced batch (host 1,000-9,000 ns) holds `ops` (trace
    clock = host clock) and whose program ring holds `spans`."""
    tracing.RECORDER.clear()
    for name, a, b, attrs in spans:
        tracing.RECORDER.record(name, a, b, attrs=attrs)
    logged = []
    return types.SimpleNamespace(
        peaks=PEAKS, work=_work(), log=logged.append, logged=logged,
        slice=Slice(t0=0, t1=10_000, device=ops, host=[]),
        mix={"new_tokens": steps},
        state={"batches": [{"traced": True, "host_ns": (1_000, 9_000),
                            "prompts": [[1] * n for n in lens]}]})


PHASES = [("generate.prefill", 1_000, 4_000, None),
          ("generate.decode", 4_000, 9_000, None)]


def test_mla_decode_roofline_from_its_launches():
    ops = [(4_100 + 100 * i, 4_150 + 100 * i, "mla_decode_split_kernel")
           for i in range(6)]
    ops += [(2_000, 3_000, "mla_decode_split_kernel")]   # in the prefill
    ops += [(8_000, 8_100, "mla_decode_combine_kernel")]
    run = _traced(sorted(ops), PHASES)
    nbytes = sum(run.work.mla_decode_bytes([3 + i, 5 + i]) for i in range(2))
    got = metric_reader(REPO, "mla_decode_roofline").read(run)
    assert got == pytest.approx(100 * nbytes / 1e12 / (400e-9))
    run.mix = {"new_tokens": 3}         # a third of the launches lost
    nbytes3 = sum(run.work.mla_decode_bytes([3 + i, 5 + i])
                  for i in range(3))
    assert metric_reader(REPO, "mla_decode_roofline").read(run) == \
        pytest.approx(100 * nbytes3 * 6 / 9 / 1e12 / 400e-9)
    assert run.logged
    # a program without the spans: nothing, and no exception
    run = _traced(sorted(ops), [])
    assert metric_reader(REPO, "mla_decode_roofline").read(run) is None


def test_mla_prefill_and_expert_stream_rooflines():
    ops = [(1_500, 2_500, "flash_attention_kernel<12, 8>"),
           (5_000, 5_100, "moe_expert_stream_kernel"),
           (5_100, 5_200, "moe_expert_finalize_kernel"),
           (5_200, 5_300, "moe_expert_stream_kernel"),
           (5_300, 5_400, "moe_expert_finalize_kernel")]
    run = _traced(ops, PHASES, steps=1)
    flops = run.work.mla_prefill_flops([(0, 3), (0, 5)])
    assert metric_reader(REPO, "mla_prefill_roofline").read(run) == \
        pytest.approx(100 * flops / 1e15 / 1e-6)
    # 2 MoE layers x 2 stream launches expected for one step; 2 traced
    nbytes = 1 * 2 * run.work.expert_bytes(2) * 2 / 4
    assert metric_reader(REPO, "expert_stream_roofline").read(run) == \
        pytest.approx(100 * nbytes / 1e12 / 400e-9)


def test_expert_rows_max_over_mean_reads_the_prefills_routes():
    routes = [("moe.prefill_route", 1_500 + 100 * i, 1_550 + 100 * i,
               {"rows_max": m, "rows_mean": 4.0, "experts": 8, "pairs": 32})
              for i, m in enumerate((6, 8))]
    late = [("moe.prefill_route", 9_500, 9_600,
             {"rows_max": 32, "rows_mean": 4.0, "experts": 8, "pairs": 32})]
    run = _traced([], PHASES + routes + late)
    got = metric_reader(REPO, "expert_rows_max_over_mean.prefill").read(run)
    assert got == pytest.approx((6 / 4 + 8 / 4) / 2)
