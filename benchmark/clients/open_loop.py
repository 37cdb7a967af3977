"""Open-loop serving: the paged engine behind `ServingLoop`, requests
submitted on an arrival schedule whatever the engine's state.

Set-up makes the engine with the mix's `engine` settings, captures every
decode horizon and every (prompt bucket, row count) of prefill chunk that
the mix's lengths can produce under the engine's prefill budget, and starts
the serving loop's thread. The window submits each request at its due
time (lib/traffic.open_loop) with a listener that stamps each token as the
client receives it; times are taken from the due time. After the close
every request gets until `wait_after_close_s` to finish; one that has not
is missing. Set-up ends with `warmup_s` of the same traffic (another
stream of the seed). With a trace, `trace_s` of the window's middle third
is profiled (kernels only), and each prefill and decode dispatch is
stamped on the host with its inputs.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.lib import traffic
from benchmark.lib.trace import Profiler


class TimedTokens(list):
    """A stream listener: each token appended with its arrival time."""

    def __init__(self):
        super().__init__()
        self.times = []

    def append(self, tok):
        self.times.append(time.perf_counter())
        super().append(tok)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def chunk_sizes(mix: dict, ec) -> set:
    """Every prefill chunk length the mix's prompts can give: each prompt
    split into chunks of at most `max_prefill_chunk` after the prefix the
    radix cache can match (whole blocks of a shared prefix, at most all
    but the prompt's last token)."""
    c, bs = ec.max_prefill_chunk, ec.block_size
    p, sh = mix["prompt"], mix.get("shared")
    lengths = [(n, 0) for n in range(p["min"], p["max"] + 1)]
    if sh:
        for tail in range(p["min"], p["max"] + 1):
            n = sh["prefix_len"] + min(tail, sh["max_prompt"]
                                       - sh["prefix_len"])
            lengths.append((n, 0))
            lengths.append((n, (min(sh["prefix_len"], n - 1) // bs) * bs))
    sizes = set()
    for n, matched in lengths:
        rest = n - matched
        while rest > 0:
            sizes.add(min(rest, c))
            rest -= min(rest, c)
    return sizes


def prefill_shapes(mix: dict, ec) -> list:
    """(bucket, rows) of every prefill dispatch the engine can make for
    the mix: a bucket's rows are a power of two at least its chunk count,
    which the per-iteration token budget bounds (a chunk is taken while
    budget is left) and the batch width caps."""
    budget = ec.prefill_tokens_per_iter or ec.max_prefill_chunk
    least: dict = {}
    for n in chunk_sizes(mix, ec):
        cb = next(b for b in ec.prompt_buckets if n <= b)
        least[cb] = min(least.get(cb, n), n)
    shapes = []
    for cb, lo in sorted(least.items()):
        most = _pow2(min(ec.max_batch, -(-budget // lo)))
        rb = 1
        while rb <= most:
            shapes.append((cb, rb))
            rb *= 2
    return shapes


def setup(run) -> None:
    from physics_llm_inference_tpu_torch.serve.http_server import ServingLoop
    from physics_llm_inference_tpu_torch.serve.paged_engine import (
        PagedEngineConfig, PagedInferenceEngine)

    ec = PagedEngineConfig(**run.mix["engine"])
    engine = PagedInferenceEngine(run.params, run.cfg, ec)
    shapes = prefill_shapes(run.mix, ec)
    engine.warmup(buckets=sorted({cb for cb, _ in shapes}))
    trash = np.full((1, ec.max_blocks_per_request), ec.num_blocks, np.int32)
    for cb, rb in shapes:
        if rb > 1:      # warmup() made each bucket at one row
            engine._prefill(np.zeros((rb, cb), np.int32),
                            np.repeat(trash, rb, axis=0),
                            np.zeros(rb, np.int32), np.ones(rb, np.int32))
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.state.update(engine=engine, warmed=set(shapes), seen=set(),
                     dispatches=[])
    _stamp_dispatches(run, engine)
    run.state["loop"] = ServingLoop(engine)
    # a burst of the mix's own traffic (its own stream of the seed): the
    # host path's first uses (eager sampling at each row count, the radix
    # tree, the scheduler's paths) happen here and not in the window, and
    # the radix cache and the pool start the window in use
    _serve(run, traffic.open_loop(run.mix, run.cfg.vocab_size, run.seed,
                                  run.mix["warmup_s"], stream=5), False)


def _stamp_dispatches(run, engine) -> None:
    """Record each prefill dispatch's (bucket, rows), and with a trace each
    dispatch's host start and inputs."""
    prefill, decode = engine._prefill, engine._decode
    seen, spans = run.state["seen"], run.state["dispatches"]

    def stamped_prefill(ids, tables, starts, nval):
        seen.add(tuple(ids.shape[::-1]))
        if run.trace:
            spans.append({"kind": "prefill", "t": time.time_ns(),
                          "chunks": [(int(s), int(n)) for s, n in
                                     zip(starts, nval) if n > 0]})
        return prefill(ids, tables, starts, nval)

    def stamped_decode(horizon, filtered, tokens, tables, *rest):
        if run.trace:
            live = tables[:, 0] != engine._trash
            spans.append({"kind": "decode", "t": time.time_ns(),
                          "horizon": horizon,
                          "lengths": engine._lengths[live].tolist()})
        return decode(horizon, filtered, tokens, tables, *rest)

    engine._prefill, engine._decode = stamped_prefill, stamped_decode


def _serve(run, reqs: list, trace: bool) -> None:
    """Submit `reqs` at their due times, then wait for each until
    `wait_after_close_s` past the close; leaves the timings in run.state.
    With `trace`, profile a slice of the window's middle third."""
    from physics_llm_inference_tpu_torch.serve.lifecycle import \
        GenerationRequest

    engine, loop, mix = run.state["engine"], run.state["loop"], run.mix
    seconds = reqs[-1]["due"] if reqs else 0.0
    trace_len = min(mix.get("trace_s", 5.0), seconds / 3)
    stats0 = engine.stats()
    prof, backlog, counted = None, [], None
    start = time.perf_counter()
    for r in reqs:
        due = start + r["due"]
        now = time.perf_counter()
        if due > now:
            time.sleep(due - now)
        if trace and prof is None and now >= start + seconds / 3:
            # kernels only: the host's operations of the loop's thread
            # make stopping the profiler slow; both are done between two
            # of the loop's steps
            prof = Profiler(run.device, host_ops=False)
            with engine._lock:
                prof.start()
            traced_from = time.perf_counter()
            run.state["dispatches"].clear()
        if (prof is not None and run.slice is None
                and time.perf_counter() >= traced_from + trace_len):
            with engine._lock:
                counted = (engine.stats(), [q for q in reqs if "id" in q])
                run.slice = prof.stop()
        r["listener"] = TimedTokens()
        r["submitted"] = time.perf_counter()
        r["id"] = engine.submit_request(
            GenerationRequest(prompt_tokens=r["prompt"],
                              max_tokens=r["max_tokens"], temperature=0.0),
            listener=r["listener"])
        loop.notify()
        sched = engine.scheduler
        backlog.append((r["submitted"] - start, len(sched.waiting),
                        len(sched.running)))
    if prof is not None and run.slice is None:
        with engine._lock:
            counted = (engine.stats(), list(reqs))
            run.slice = prof.stop()
    if run.slice is not None:
        # an idle gap is named by the dispatch whose host work it follows
        spans = run.state["dispatches"]
        run.slice.spans = [
            (d["t"], spans[i + 1]["t"] if i + 1 < len(spans) else d["t"],
             f"the engine's host work after a {d['kind']} dispatch")
            for i, d in enumerate(spans)]
    closed = time.perf_counter()
    deadline = closed + mix["wait_after_close_s"]
    for r in reqs:
        r["result"] = engine.wait_result(
            r["id"], timeout=max(0.0, deadline - time.perf_counter()))
    # stopping a profile holds the loop for seconds: counters of a traced
    # window stop where the profile does
    stats1, counted = counted or (engine.stats(), reqs)
    run.state.update(requests=reqs, start=start, closed=closed,
                     drained=time.perf_counter(), backlog=backlog,
                     stats0=stats0, stats1=stats1, counted=counted)


def window(run) -> None:
    reqs = traffic.open_loop(run.mix, run.cfg.vocab_size, run.seed,
                             run.seconds)
    _serve(run, reqs, run.trace)
    run.attempted = len(reqs)
    run.failed = sum(r["result"] is None for r in reqs)
    _log_slowest(run, reqs, run.state["start"])
    unwarmed = run.state["seen"] - run.state["warmed"]
    if unwarmed:
        run.log(f"prefill shapes captured in the window: {sorted(unwarmed)}")


def _log_slowest(run, reqs, start) -> None:
    """The ten slowest first tokens: (due s, submitted late ms, ttft ms,
    prompt tokens, shared prefix)."""
    rows = []
    for r in reqs:
        times = r["listener"].times
        if times:
            rows.append((times[0] - start - r["due"], r))
    rows.sort(key=lambda x: -x[0])
    run.log("slowest first tokens (due s, late ms, ttft ms, prompt, shared):",
            [(round(r["due"], 2), round(1e3 * (r["submitted"] - start
                                                - r["due"]), 1),
              round(1e3 * t, 1), len(r["prompt"]), r["shared"])
             for t, r in rows[:10]])


def samples(run) -> list:
    """The finished request with the longest prompt and output, one behind
    a shared prefix, and others drawn from the seed up to
    `sample.requests`."""
    done = [r for r in run.state["requests"] if r["result"] is not None]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r["prompt"]) + r["max_tokens"])
    rest = [r for r in done if r is not longest]
    g = traffic.rng(run.seed, 4)
    g.shuffle(rest)
    shared = [r for r in rest if r["shared"] is not None][:1]
    others = [r for r in rest if r not in shared]
    pick = [longest, *shared, *others][:run.mix["sample"]["requests"]]
    return [{"prompt": r["prompt"], "tokens": list(r["result"].tokens),
             "expected": r["max_tokens"]} for r in pick]


def release(run) -> None:
    loop = run.state.pop("loop", None)
    if loop is not None:
        loop.shutdown()
    run.state.pop("engine", None)


def end_to_end(run) -> dict:
    """Per request, from its due time: ttft_s (a missing request counts
    the whole wait, until the deadline after the close), tpot_s (requests
    of two tokens or more), and how late the client submitted."""
    start = run.state["start"]
    deadline = run.state["closed"] + run.mix["wait_after_close_s"]
    ttft, tpot, late = [], [], []
    for r in run.state["requests"]:
        due = start + r["due"]
        late.append(r["submitted"] - due)
        times = r["listener"].times
        if r["result"] is None or not times:
            ttft.append(deadline - due)
            continue
        ttft.append(times[0] - due)
        n = len(r["result"].tokens)
        if n >= 2:
            tpot.append((times[-1] - times[0]) / (n - 1))
    return {"ttft_s": ttft, "tpot_s": tpot, "late_s": late}
