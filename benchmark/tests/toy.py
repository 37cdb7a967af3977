"""A toy benchmark root made only of new files (a BENCHMARK.json, two
configurations, two mixes and three cells), which the harness runs on the
CPU with the port's plain kernels. The clients and metric readers are the
benchmark's own."""
from __future__ import annotations

import json
from pathlib import Path

CONFIG = {"model_type": "mistral", "hidden_size": 128,
          "intermediate_size": 256, "max_position_embeddings": 256,
          "num_attention_heads": 4, "num_hidden_layers": 2,
          "num_key_value_heads": 2,
          "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "vocab_size": 512,
          "precision": {"weights": "int8", "kv_cache": "int8",
                        "activations": "bfloat16"}}
# top-2 of 2 experts: every token meets both, so no near-tie of the router
# can flip an expert (at this size one flip moves a token's logits past the
# limit) while dispatch, the expert products and the combine all run
MOE = dict(CONFIG, model_type="mixtral", num_local_experts=2,
           num_experts_per_tok=2, assumed={"expert_capacity_factor": 1.0})
OFFLINE = {"client": "offline", "batch": 8,
           "prompt": {"dist": "uniform", "min": 8, "max": 32},
           "prompt_bucket": 32, "new_tokens": 16, "kv_dtype": "int8",
           "sample": {"requests": 3}}
CHAT = {"client": "open_loop", "rate_rps": 10.0,
        "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.6,
                   "min": 8, "max": 48},
        "output": {"dist": "lognormal", "median": 8, "sigma": 0.5,
                   "min": 4, "max": 16},
        "shared": {"every": 4, "prefixes": 2, "prefix_len": 16,
                   "max_prompt": 48},
        "engine": {"num_blocks": 48, "block_size": 16, "max_batch": 8,
                   "max_blocks_per_request": 4, "max_prefill_chunk": 32,
                   "prompt_buckets": [16, 32], "decode_horizon": 4,
                   "kv_dtype": "int8", "enable_radix": True,
                   "prefill_tokens_per_iter": 64},
        "wait_after_close_s": 30, "warmup_s": 0.5, "trace_s": 0.5,
        "sample": {"requests": 4}}
# bf16 activations against the float32 reference read gaps of 0.01-0.25
# at this size; a token altered reads ~1 or more
LIMIT = 0.5
MEAN_LIMIT = 0.05

SPEC = {
    "command": ["python3", "benchmark/run.py"], "paths": ["benchmark"],
    "run_seconds": 2,
    "configs": [
        {"name": "toy", "source": "a test", "reduced": [],
         "file": "benchmark/configs/toy.json"},
        {"name": "toy_moe", "source": "a test", "reduced": [],
         "file": "benchmark/configs/toy_moe.json"}],
    "workloads": [
        {"name": "toy.decode", "config": "toy", "traffic": "toy_offline",
         "chips": 1, "why": "a test"},
        {"name": "toy.serve", "config": "toy", "traffic": "toy_chat",
         "chips": 1, "why": "a test"},
        {"name": "toy_moe.decode", "config": "toy_moe",
         "traffic": "toy_offline", "chips": 1, "why": "a test"}],
    "end_to_end": [
        {"name": "output_tok_s", "unit": "tokens/s", "better": "higher",
         "bound": 0.1, "source": "host_clock",
         "workloads": ["toy.decode", "toy_moe.decode"]},
        {"name": "ttft_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.1, "source": "host_clock", "workloads": ["toy.serve"]},
        {"name": "tpot_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.1, "source": "host_clock", "workloads": ["toy.serve"]},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"}],
    "per_layer": [
        {"name": "prefill_ms.offline", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "offline entry",
         "moves": "output_tok_s",
         "workloads": ["toy.decode", "toy_moe.decode"]},
        {"name": "decode_step_ms.offline", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "offline entry",
         "moves": "output_tok_s",
         "workloads": ["toy.decode", "toy_moe.decode"]},
        {"name": "prefix_hit_share.serve", "unit": "%", "better": "higher",
         "source": "program_counter", "layer": "serving front",
         "moves": "ttft_p95_ms", "workloads": ["toy.serve"]},
        {"name": "preemptions.serve", "unit": "count", "better": "lower",
         "source": "program_counter", "layer": "serving front",
         "moves": "tpot_p95_ms", "workloads": ["toy.serve"]}],
}


def make_root(root: Path) -> Path:
    """Write the toy benchmark's files under `root`; returns it."""
    files = {
        "BENCHMARK.json": SPEC,
        "benchmark/configs/toy.json": CONFIG,
        "benchmark/configs/toy_moe.json": MOE,
        "benchmark/traffic/toy_offline.json": OFFLINE,
        "benchmark/traffic/toy_chat.json": CHAT,
    }
    for cell in ("toy.decode", "toy.serve", "toy_moe.decode"):
        files[f"benchmark/cells/{cell}.json"] = {
            "limits": {"logit_gap_max": LIMIT, "logit_gap_mean": MEAN_LIMIT}}
    for rel, obj in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(obj))
    return root
