"""Serving benchmark harness (ref ch10/benchmark.py).

Closed-loop load generator against a `generate_fn`: warmup, then sequential
or thread-concurrent request waves (ref :98-143); reports TTFT and E2E
latency mean/P50/P90/P99 plus requests/s and tokens/s (ref BenchmarkResult
:27-74). The schema matches the reference so results are comparable 1:1.

`generate_fn(prompt_tokens, max_tokens) -> dict` must return at least
{"tokens": list[int]} and may include "ttft_s".

A copy of physics_llm_inference_tpu/bench/harness.py: the original's package
imports jax (its bench/__init__.py imports bench/micro.py), so it cannot
load here.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field


def percentile(values: list[float], p: float) -> float:
    """Ref ch10/benchmark.py:77-83."""
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, int(round((p / 100) * (len(vs) - 1))))
    return vs[idx]


@dataclass
class BenchmarkConfig:
    """Ref BenchmarkConfig ch10/benchmark.py:9-15."""

    num_requests: int = 32
    concurrency: int = 1
    warmup_requests: int = 2
    prompt_len: int = 32
    max_tokens: int = 32


@dataclass
class BenchmarkResult:
    """Ref BenchmarkResult ch10/benchmark.py:27-74."""

    num_requests: int = 0
    total_time_s: float = 0.0
    total_tokens: int = 0
    latencies_s: list = field(default_factory=list)
    ttfts_s: list = field(default_factory=list)

    @property
    def requests_per_s(self) -> float:
        return self.num_requests / self.total_time_s if self.total_time_s else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / self.total_time_s if self.total_time_s else 0.0

    def _stats(self, vals):
        if not vals:
            return {}
        return {
            "mean_ms": sum(vals) / len(vals) * 1e3,
            "p50_ms": percentile(vals, 50) * 1e3,
            "p90_ms": percentile(vals, 90) * 1e3,
            "p99_ms": percentile(vals, 99) * 1e3,
        }

    def to_dict(self) -> dict:
        return {
            "num_requests": self.num_requests,
            "total_time_s": self.total_time_s,
            "requests_per_s": self.requests_per_s,
            "tokens_per_s": self.tokens_per_s,
            "latency": self._stats(self.latencies_s),
            "ttft": self._stats(self.ttfts_s),
        }

    def summary(self) -> str:
        """Human report (ref summary() ch10/benchmark.py:51-74)."""
        d = self.to_dict()
        lines = [
            f"requests: {d['num_requests']}  time: {d['total_time_s']:.2f}s",
            f"throughput: {d['requests_per_s']:.2f} req/s, "
            f"{d['tokens_per_s']:.1f} tok/s",
        ]
        for name in ("latency", "ttft"):
            if d[name]:
                s = d[name]
                lines.append(
                    f"{name}: mean {s['mean_ms']:.1f} ms  P50 {s['p50_ms']:.1f}"
                    f"  P90 {s['p90_ms']:.1f}  P99 {s['p99_ms']:.1f}")
        return "\n".join(lines)


def run_benchmark(config: BenchmarkConfig, generate_fn,
                  prompt_fn=None) -> BenchmarkResult:
    """Ref run_benchmark ch10/benchmark.py:86-169: warmup → timed closed-loop
    load at the configured concurrency."""
    prompt_fn = prompt_fn or (lambda i: list(range(1, config.prompt_len + 1)))

    for i in range(config.warmup_requests):
        generate_fn(prompt_fn(i), config.max_tokens)

    result = BenchmarkResult()

    def one(i: int):
        t0 = time.perf_counter()
        out = generate_fn(prompt_fn(i), config.max_tokens)
        dt = time.perf_counter() - t0
        return out, dt

    t_start = time.perf_counter()
    if config.concurrency <= 1:
        outs = [one(i) for i in range(config.num_requests)]
    else:
        with ThreadPoolExecutor(max_workers=config.concurrency) as ex:
            outs = list(ex.map(one, range(config.num_requests)))
    result.total_time_s = time.perf_counter() - t_start

    for out, dt in outs:
        result.num_requests += 1
        result.latencies_s.append(dt)
        result.total_tokens += len(out.get("tokens", []))
        if out.get("ttft_s") is not None:
            result.ttfts_s.append(out["ttft_s"])
    return result
