"""Headline benchmark on the card: decode tokens/s on the flagship dense
model, by the protocol of the repository's root `bench.py` (lines 27-135).

    python3 -m physics_llm_inference_tpu_torch.bench.headline

Prints ONE JSON line on stdout, with bench.py's keys:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "ttft_p50_ms": N}
`vs_baseline` is the measured decode throughput over the memory-bound
speed of light of the same step (every weight byte at its width and every
live INT8 KV byte read from HBM once a step, `specs/gpu.decode_step_floor_s`,
the definition of bench.py:115-125). Diagnostics, the card's name and its
power limit go to stderr.

The knobs are bench.py's environment variables: BENCH_MODEL (7b, or 0.85b),
BENCH_BATCH, BENCH_ATTN, BENCH_ACT (int8: W8A8) and BENCH_WBITS (4: W4A16).
The weights are random, made from seed 0; at 7B directly in int8 or INT4.
One warm run (the decode loop's CUDA graph is captured there), then the
median of 5 by decode tok/s; TTFT is that run's prefill.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.quant import (init_params_int4, init_params_int8,
                            quantize_params_int4, quantize_params_int8)
from ..models.transformer import init_params
from ..runtime.generate import cached_generate, decode_step_cache
from ..runtime.kv_cache import calculate_kv_cache_size
from ..specs.gpu import GPUSpec, decode_step_floor_s, get_gpu_spec

# bench.py:43-51
SHAPES = {
    "0.85b": dict(hidden_dim=2048, num_layers=16, num_heads=16,
                  num_kv_heads=4, intermediate_dim=5632),
    "7b": dict(hidden_dim=4096, num_layers=32, num_heads=32,
               num_kv_heads=8, intermediate_dim=11008),
}
PROMPT_LEN, NEW_TOKENS, RUNS = 128, 128, 5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_of(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without CUDA raises (a
    bench runs on the CPU only when asked to)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass device='cpu' (--device cpu) "
                         "to run on the CPU")
    return dev


def median_run(outs: list):
    """The run of median decode tok/s (bench.py:104-105)."""
    outs = sorted(outs, key=lambda o: o.decode_tokens_per_s)
    return outs[len(outs) // 2]


def speed_of_light_tok_s(cfg: ModelConfig, batch: int, prompt_len: int,
                         new_tokens: int, wbits: int, spec: GPUSpec) -> float:
    """Decode tok/s at the memory-bound floor: param_count at `wbits` bits
    (scales left out) plus the INT8 KV of batch x (prompt + new), over the
    card's HBM bandwidth, as bench.py:115-125 computes it."""
    kv = calculate_kv_cache_size(batch, prompt_len + new_tokens,
                                 cfg.num_layers, cfg.num_kv_heads,
                                 cfg.head_dim, 1)
    floor = decode_step_floor_s(cfg.param_count() * wbits // 8,
                                kv["total_bytes"], spec)
    return batch / floor


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        else f"nvidia-smi failed: {res.stderr.strip()}"


def main(device="cuda", shapes: dict | None = None,
         spec: GPUSpec | None = None) -> dict:
    """Run the protocol; print and return bench.py's dict. `shapes` and
    `spec` replace SHAPES and the card's detected spec (a test on the CPU
    passes a tiny shape and the H100's spec)."""
    device = torch.device(device)
    spec = spec or get_gpu_spec()
    model = os.environ.get("BENCH_MODEL", "7b")
    cfg = ModelConfig(vocab_size=32000, max_seq_len=2048, dtype="bfloat16",
                      attention_impl=os.environ.get("BENCH_ATTN", "auto"),
                      act_quant=os.environ.get("BENCH_ACT", "none"),
                      **(shapes or SHAPES)[model])
    batch = int(os.environ.get("BENCH_BATCH",
                               "64" if model == "7b" else "128"))
    wbits = int(os.environ.get("BENCH_WBITS", "8"))
    if device.type == "cuda":
        log(f"card: {_card()} | torch {torch.__version__} CUDA "
            f"{torch.version.cuda}")
    log(f"model: {cfg.param_count() / 1e9:.2f}B params INT{wbits} W + INT8 "
        f"KV, batch {batch}, prompt {PROMPT_LEN}, decode {NEW_TOKENS}")

    gen = torch.Generator(device=device).manual_seed(0)
    if model == "7b":
        init = init_params_int4 if wbits == 4 else init_params_int8
        params = init(gen, cfg, device=device)
    else:
        params = quantize_params_int8(init_params(gen, cfg, device=device))
        if wbits == 4:
            params = quantize_params_int4(params)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, PROMPT_LEN))
               for _ in range(batch)]
    steps = decode_step_cache()

    def run():
        return cached_generate(params, cfg, prompts, NEW_TOKENS,
                               temperature=0.0, kv_dtype=torch.int8,
                               step_cache=steps)

    t0 = time.perf_counter()
    run()
    log(f"warm run (decode loop captured): {time.perf_counter() - t0:.1f} s")
    outs = []
    for _ in range(RUNS):
        out = run()
        outs.append(out)
        log(f"steady: prefill {out.prefill_s * 1e3:.1f} ms, decode "
            f"{out.decode_s * 1e3:.1f} ms, {out.decode_tokens_per_s:.1f} "
            "tok/s")
    out = median_run(outs)
    tok_s = out.decode_tokens_per_s
    sol = speed_of_light_tok_s(cfg, batch, PROMPT_LEN, NEW_TOKENS, wbits,
                               spec)
    log(f"roofline floor: {batch / sol * 1e6:.0f} us/step -> {sol:.0f} "
        f"tok/s speed of light on {spec.name}; decode cache "
        f"{steps.stats()}")
    result = {
        "metric": "decode_tokens_per_s_per_chip",
        "value": round(tok_s, 1),
        "unit": "tokens/s",
        "vs_baseline": round(tok_s / sol, 4),
        "ttft_p50_ms": round(out.prefill_s * 1e3, 1),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
