"""MoE decode throughput on the card (BASELINE config 5), by the protocol of
the repository's `scripts/bench_moe.py`, with its flags, defaults and JSON
keys.

    python3 -m physics_llm_inference_tpu_torch.bench.moe [--batch 32] [--layers 16] [--engine]

An INT8 MoE config (vocab 32000, hidden 2048, 16 q / 4 kv heads, 8 experts
top-2 of FFN 2816, capacity factor 1.25, INT8 weights and KV) serves
through `cached_generate` (per-op decode: K4 has no MoE mode) and reports
decode tok/s and TTFT against two floors, on the card's spec
(`specs/gpu`):
- all-expert floor: every parameter and the live KV read once a step
  (what the capacity-grid dispatch's batched products do: they read all
  E experts whatever the routing);
- active-expert floor: only the routed top-k experts' share of the expert
  weights.
One warm run, then the median of 3 by decode tok/s; TTFT is that run's
prefill. `--engine` serves the model through the slot engine instead (32
slots, INT8 pool, horizon 8, prompt bucket 128) behind a `ServingLoop`:
2 x batch closed-loop requests at concurrency `batch`, a warm wave, then
the timed one, reported by `bench/harness`. The weights are random, from
seed 0: `quantize_params_int8(init_params(...))` on the device (a 5 GB
bf16 transient at config 5). One JSON line on stdout; diagnostics, the
card's name and its power limit on stderr.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.quant import QuantizedTensor, quantize_params_int8
from ..models.transformer import init_params
from ..runtime.generate import cached_generate, decode_step_cache
from ..specs.gpu import GPUSpec, get_gpu_spec
from .headline import _card, log, median_run
from .harness import BenchmarkConfig, run_benchmark

RUNS = 3


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m physics_llm_inference_tpu"
                                 "_torch.bench.moe")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=2048)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--topk", type=int, default=2)
    ap.add_argument("--expert-ff", type=int, default=2816)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--decode", type=int, default=64)
    ap.add_argument("--no-fused", action="store_true",
                    help="force the per-op decode path (an MoE config is "
                         "always per-op)")
    ap.add_argument("--engine", action="store_true",
                    help="serve the model through the slot engine instead "
                         "of cached_generate")
    return ap.parse_args(argv)


def moe_config(args) -> ModelConfig:
    """scripts/bench_moe.py's ModelConfig from its flags."""
    return ModelConfig(vocab_size=32000, max_seq_len=1024, dtype="bfloat16",
                       hidden_dim=args.hidden, num_layers=args.layers,
                       num_heads=args.hidden // 128, num_kv_heads=4,
                       intermediate_dim=args.expert_ff,
                       num_experts=args.experts,
                       num_experts_per_tok=args.topk,
                       expert_capacity_factor=1.25,
                       fused_decode=not args.no_fused)


def param_counts(params: dict, cfg: ModelConfig, topk: int) -> tuple:
    """(total, active) parameters as scripts/bench_moe.py counts them: each
    leaf's size, a quantized leaf by its int8 values (scales left out);
    active keeps the routed top-k share of the expert stacks."""
    def leaves(tree):
        if isinstance(tree, dict):
            for t in tree.values():
                yield from leaves(t)
        else:
            yield tree.q if isinstance(tree, QuantizedTensor) else tree

    total = sum(t.numel() for t in leaves(params))
    expert_w = (cfg.num_layers * cfg.num_experts * 3 * cfg.hidden_dim
                * cfg.intermediate_dim)
    active = total - expert_w + (expert_w * topk // cfg.num_experts
                                 if cfg.num_experts else 0)
    return total, active


def floors_s(total: int, active: int, cfg: ModelConfig, batch: int,
             prompt: int, decode: int, spec: GPUSpec) -> tuple:
    """(all-expert, active-expert) floors of a decode step in seconds, as
    scripts/bench_moe.py computes them: the parameters at one byte each
    (INT8) plus the INT8 KV of batch x (prompt + decode), over the card's
    HBM bandwidth."""
    kv_bytes = (2 * cfg.num_layers * batch * (prompt + decode)
                * cfg.num_kv_heads * cfg.head_dim)
    return ((total + kv_bytes) / spec.hbm_bandwidth,
            (active + kv_bytes) / spec.hbm_bandwidth)


def serve_engine(params, cfg: ModelConfig, args, rng) -> dict:
    """--engine: the slot engine behind a ServingLoop, the script's closed
    loop of 2 x batch requests (a warm wave, then the timed one)."""
    from ..serve.engine import EngineConfig, GenerationRequest, \
        InferenceEngine
    from ..serve.http_server import ServingLoop

    ec = EngineConfig(num_slots=args.batch,
                      max_seq_len=-(-(args.prompt + args.decode) // 128) * 128,
                      kv_dtype="int8", decode_horizon=8,
                      prompt_buckets=(128,))
    engine = InferenceEngine(params, cfg, ec)
    if engine.device.type == "cuda":
        log(f"[moe-engine] warmup (captures): {engine.warmup():.1f} s")
    loop = ServingLoop(engine)

    def generate_fn(prompt_tokens, max_tokens):
        rid = engine.submit_request(GenerationRequest(
            prompt_tokens=prompt_tokens, max_tokens=max_tokens,
            temperature=0.0))
        loop.notify()
        res = engine.wait_result(rid, timeout=900.0)
        if res is None:
            raise RuntimeError("the engine's serving loop gave no result")
        return {"tokens": res.tokens, "ttft_s": res.ttft_s}

    def prompt_fn(i):
        return list(rng.integers(1, cfg.vocab_size, args.prompt))

    n_req = 2 * args.batch
    try:
        t0 = time.time()
        run_benchmark(BenchmarkConfig(num_requests=n_req,
                                      concurrency=args.batch,
                                      warmup_requests=1,
                                      prompt_len=args.prompt,
                                      max_tokens=args.decode),
                      generate_fn, prompt_fn)
        log(f"[moe-engine] warm wave done at {time.time() - t0:.0f}s")
        result = run_benchmark(BenchmarkConfig(num_requests=n_req,
                                               concurrency=args.batch,
                                               warmup_requests=0,
                                               prompt_len=args.prompt,
                                               max_tokens=args.decode),
                               generate_fn, prompt_fn)
    finally:
        loop.shutdown()
    out = result.to_dict()
    out["metric"] = "moe_serving_slot_engine"
    out["config"] = {"slots": args.batch, "prompt": args.prompt,
                     "decode": args.decode, "horizon": 8}
    log(result.summary())
    return out


def main(argv=(), device="cuda", spec: GPUSpec | None = None) -> dict:
    """Run the protocol; print and return its dict. `spec` replaces the
    card's detected spec (a test on the CPU passes the H100's)."""
    args = parse_args(list(argv))
    device = torch.device(device)
    spec = spec or get_gpu_spec()
    cfg = moe_config(args)
    if device.type == "cuda":
        log(f"card: {_card()} | torch {torch.__version__} CUDA "
            f"{torch.version.cuda}")
    gen = torch.Generator(device=device).manual_seed(0)
    params = quantize_params_int8(init_params(gen, cfg, device=device))
    total, active = param_counts(params, cfg, args.topk)
    log(f"MoE: {total / 1e9:.2f}B total / {active / 1e9:.2f}B active params "
        f"({args.experts} experts top-{args.topk}), INT8 W+KV, batch "
        f"{args.batch}")
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, args.prompt))
               for _ in range(args.batch)]

    if args.engine:
        out = serve_engine(params, cfg, args, rng)
        print(json.dumps(out), flush=True)
        return out

    steps = decode_step_cache()

    def run():
        return cached_generate(params, cfg, prompts, args.decode,
                               temperature=0.0, kv_dtype=torch.int8,
                               step_cache=steps)

    t0 = time.time()
    run()
    log(f"warm run (decode loop captured): {time.time() - t0:.1f}s")
    runs = []
    for _ in range(RUNS):
        out = run()
        runs.append(out)
        log(f"steady: prefill {out.prefill_s * 1e3:.1f} ms, "
            f"{out.decode_tokens_per_s:.1f} tok/s")
    out = median_run(runs)

    floor_all, floor_active = floors_s(total, active, cfg, args.batch,
                                       args.prompt, args.decode, spec)
    sol_all = args.batch / floor_all
    sol_active = args.batch / floor_active
    log(f"floors on {spec.name} ({spec.hbm_gbps:.0f} GB/s): all-expert "
        f"{floor_all * 1e3:.3f} ms a step, active-expert "
        f"{floor_active * 1e3:.3f} ms; median run decode "
        f"{out.decode_s / args.decode * 1e3:.3f} ms a step")
    result = {
        "metric": "moe_decode_tokens_per_s_per_chip",
        "value": round(out.decode_tokens_per_s, 1),
        "unit": "tokens/s",
        "vs_all_expert_floor": round(out.decode_tokens_per_s / sol_all, 4),
        "vs_active_expert_floor": round(
            out.decode_tokens_per_s / sol_active, 4),
        "ttft_p50_ms": round(out.prefill_s * 1e3, 1),
        "total_params_b": round(total / 1e9, 2),
        "active_params_b": round(active / 1e9, 2),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
