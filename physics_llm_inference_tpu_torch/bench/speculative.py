"""Speculative decoding at the 7B config through the slot engine, by the
protocol of the repository's `scripts/bench_speculative.py`, with its flags,
defaults and JSON rows.

    python3 -m physics_llm_inference_tpu_torch.bench.speculative [--k 4] [--slots 8]

Tok/s and accepted tokens per dispatch with `EngineConfig.speculative_k`
at 0 and at `--k`, on two prompt classes from `np.random.default_rng(0)`:
repetitive (a cycled 16-token pattern, which prompt-lookup drafts hit) and
random (where a random-init model's greedy continuation rarely restates the
prompt: the cost of drafting and of the (slots, k + 1) verify window when
little is accepted). The slot engine (`--slots` slots of 512 positions,
INT8 KV, greedy) serves each case; on the card its steps are captured in
`warmup()` and by an untimed run of the same requests before the timed one
(the script's wall holds its first-call compiles), so `wall_s` is the
replayed run's. `tokens_per_dispatch` and `dispatches` are the timed run's.
`run_case` also serves other weights and prompts (chip_smoke's trained
checkpoint). One JSON line a case and a final one on stdout.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.quant import init_params_int8
from .headline import _card, device_of, log


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m physics_llm_inference_tpu"
                                 "_torch.bench.speculative")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--decode", type=int, default=64)
    return ap.parse_args(argv)


def model_config() -> ModelConfig:
    """The script's 7B config (vocab 32000, 512 positions)."""
    return ModelConfig(vocab_size=32000, max_seq_len=512, dtype="bfloat16",
                       hidden_dim=4096, num_layers=32, num_heads=32,
                       num_kv_heads=8, intermediate_dim=11008)


def prompts(rng, vocab: int, slots: int, prompt: int) -> tuple[list, list]:
    """The script's two prompt classes (bench_speculative.py:71-77), drawn
    from `rng` in its order: (repetitive, random)."""
    pat = list(rng.integers(1, vocab, 16))
    rep = [(pat * (prompt // 16 + 1))[:prompt] for _ in range(slots)]
    rnd = [list(rng.integers(1, vocab, prompt)) for _ in range(slots)]
    return rep, rnd


def _spec(eng) -> tuple[int, float]:
    s = eng.stats().get("speculative", {})
    n = s.get("dispatches", 0)
    return n, s.get("tokens_per_dispatch", 0.0) * n


def run_case(params, cfg: ModelConfig, k: int, prompts_: list, decode: int,
             label: str) -> dict:
    """One case: a slot engine of len(prompts_) slots with speculative_k
    = k serving the prompts greedily for `decode` tokens; its row."""
    from ..serve.engine import EngineConfig, GenerationRequest, \
        InferenceEngine

    eng = InferenceEngine(params, cfg, EngineConfig(
        num_slots=len(prompts_), max_seq_len=512, kv_dtype="int8",
        speculative_k=k))
    cuda = eng.device.type == "cuda"

    def serve() -> tuple[list, float]:
        rids = [eng.submit_request(GenerationRequest(
            prompt_tokens=p, max_tokens=decode, temperature=0.0))
            for p in prompts_]
        t0 = time.perf_counter()
        eng.run_until_done(rids)
        if cuda:
            torch.cuda.synchronize(eng.device)
        return [eng.get_result(r).tokens for r in rids], \
            time.perf_counter() - t0

    if cuda:
        eng.warmup()
        serve()
    n0, acc0 = _spec(eng)
    toks, wall = serve()
    n1, acc1 = _spec(eng)
    total = sum(len(t) for t in toks)
    row = {
        "case": label, "k": k, "wall_s": round(wall, 4),
        "tokens": total, "tok_per_s": round(total / wall, 1),
        "tokens_per_dispatch": round((acc1 - acc0) / (n1 - n0), 3)
        if n1 > n0 else 1.0,
        "dispatches": n1 - n0,
    }
    print(json.dumps(row), flush=True)
    row["outputs"] = toks
    return row


def main(argv=(), device="cuda", cfg: ModelConfig | None = None) -> dict:
    """Run the protocol; print and return its dict (each row also carries
    its requests' tokens under "outputs", left out of the printed line).
    `cfg` replaces the 7B config (a test on the CPU passes a toy one)."""
    args = parse_args(list(argv))
    device = device_of(device)
    cfg = cfg or model_config()
    if device.type == "cuda":
        log(f"[spec] card: {_card()} | torch {torch.__version__} CUDA "
            f"{torch.version.cuda}")
    log(f"[spec] init INT8 params ({cfg.num_layers} layers)...")
    params = init_params_int8(torch.Generator(device=device).manual_seed(0),
                              cfg)
    rep, rnd = prompts(np.random.default_rng(0), cfg.vocab_size, args.slots,
                       args.prompt)
    rows = []
    for label, ps in (("repetitive", rep), ("realistic", rnd)):
        for k in (0, args.k):
            rows.append(run_case(params, cfg, k, ps, args.decode, label))
    out = {"metric": "speculative_7b", "rows": rows,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    print(json.dumps({**out, "rows": [{k: v for k, v in r.items()
                                       if k != "outputs"} for r in rows]}),
          flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
