"""Offline batches through `cached_generate`, back to back.

Each batch is `batch` greedy prompts left-padded to `prompt_bucket`, with
`new_tokens` new tokens each, drawn from the seed (lib/traffic.py). The
decode loop is captured once per shape (`decode_step_cache`); set-up runs
one batch of the same shape, so nothing is built or captured in the
window. Batches start while the window is open; the last one runs to its
end. With a trace, batch 1 is profiled whole.
"""
from __future__ import annotations

import time

import torch

from benchmark.lib import traffic
from benchmark.lib.trace import Profiler

TRACED_BATCH = 1
WARMUP_STREAM = 1 << 40


def _generate(run, prompts):
    from physics_llm_inference_tpu_torch.runtime.generate import \
        cached_generate

    mix = run.mix
    return cached_generate(
        run.params, run.cfg, prompts, mix["new_tokens"], temperature=0.0,
        prompt_bucket=mix["prompt_bucket"],
        kv_dtype=torch.int8 if mix["kv_dtype"] == "int8" else None,
        step_cache=run.state["step_cache"])


def setup(run) -> None:
    from physics_llm_inference_tpu_torch.runtime.generate import \
        decode_step_cache

    run.state["step_cache"] = decode_step_cache()
    _generate(run, traffic.offline_batch(run.mix, run.cfg.vocab_size,
                                         run.seed, WARMUP_STREAM))


def window(run) -> None:
    """Batches while the window is open (a traced run runs at least
    TRACED_BATCH + 1 of them)."""
    batches = []
    close = time.perf_counter() + run.seconds
    least = TRACED_BATCH + 1 if run.trace else 1
    while len(batches) < least or time.perf_counter() < close:
        i = len(batches)
        prompts = traffic.offline_batch(run.mix, run.cfg.vocab_size,
                                        run.seed, i)
        traced = run.trace and i == TRACED_BATCH
        prof = Profiler(run.device) if traced else None
        if traced:
            prof.start()
        t0, h0 = time.perf_counter(), time.time_ns()
        out = _generate(run, prompts)
        t1, h1 = time.perf_counter(), time.time_ns()
        if traced:
            run.slice = prof.stop()
            run.slice.spans.append((h0, h1, "cached_generate"))
        batches.append({"prompts": prompts, "out": out, "t0": t0, "t1": t1,
                        "host_ns": (h0, h1), "traced": traced})
    run.state["batches"] = batches
    run.attempted = sum(len(b["prompts"]) for b in batches)


def samples(run) -> list:
    """The row with the longest prompt and `sample.requests` - 1 others
    drawn from the seed, each {prompt, tokens, expected}."""
    rows = [(b["prompts"][j], b["out"].tokens[j][:b["out"].gen_lens[j]])
            for b in run.state["batches"] for j in range(len(b["prompts"]))]
    longest = max(range(len(rows)), key=lambda i: len(rows[i][0]))
    rest = [i for i in range(len(rows)) if i != longest]
    pick = traffic.rng(run.seed, 4).choice(
        rest, size=min(len(rest), run.mix["sample"]["requests"] - 1),
        replace=False)
    return [{"prompt": rows[i][0], "tokens": [int(t) for t in rows[i][1]],
             "expected": run.mix["new_tokens"]}
            for i in [longest, *pick.tolist()]]


def release(run) -> None:
    run.state.pop("step_cache", None)


def end_to_end(run) -> dict:
    """Quantities the end-to-end metrics read."""
    b = run.state["batches"]
    tokens = sum(int(x["out"].gen_lens.sum()) for x in b)
    return {"output_tokens": tokens, "wall_s": b[-1]["t1"] - b[0]["t0"]}
