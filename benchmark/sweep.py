"""The rate sweep of an open-loop cell: one set-up, then one window at
each offered rate (a fresh seed each, so no rate finds another's prefixes
cached), reporting each rate's tails and whether the backlog grew.

    python3 benchmark/sweep.py --workload mistral7b.serve \
        --rates 8,10,12 --seconds 30 --seed 7

One JSON line a rate. The knee is the highest rate whose waiting queue
does not grow through the window and drains within a few seconds of the
close; the cell's mix runs at about 0.8 of it (its `rate_rps`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run as bench  # noqa: E402


def _mean(xs):
    return sum(xs) / len(xs) if xs else 0.0


def main() -> int:
    import torch

    from benchmark.lib import arith, spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    cell = spec.load_cell(bench.ROOT, args.workload)
    dev = torch.device("cuda")
    arch = spec.arch(bench.ROOT, cell.config)
    run = bench.Run(cell, args.seed, args.seconds, False, dev)
    run.cfg = arch.model_config(cell.config)
    w = arch.weights(cell.config, args.seed, dev)
    run.params = arch.program_params(w)
    client = spec.client(bench.ROOT, cell.traffic["client"])
    t0 = time.time()
    client.setup(run)
    print(f"[sweep] set-up {time.time() - t0:.1f} s", file=sys.stderr)
    base = dict(cell.traffic)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        run.mix = dict(base, rate_rps=rate)
        run.seed = args.seed + 1 + i
        client.window(run)
        e = client.end_to_end(run)
        back = run.state["backlog"]
        third = max(1, len(back) // 3)
        out_tokens = sum(len(r["result"].tokens) for r in
                         run.state["requests"] if r["result"] is not None)
        line = {
            "rate_rps": rate, "requests": run.attempted,
            "missing": run.failed,
            "ttft_p50_ms": arith.percentile(e["ttft_s"], 50) * 1e3,
            "ttft_p95_ms": arith.percentile(e["ttft_s"], 95) * 1e3,
            "tpot_p50_ms": arith.percentile(e["tpot_s"], 50) * 1e3,
            "tpot_p95_ms": arith.percentile(e["tpot_s"], 95) * 1e3,
            "late_p95_ms": arith.percentile(e["late_s"], 95) * 1e3,
            "waiting_first_third": _mean([b[1] for b in back[:third]]),
            "waiting_last_third": _mean([b[1] for b in back[-third:]]),
            "running_last_third": _mean([b[2] for b in back[-third:]]),
            "drain_s": run.state["drained"] - run.state["closed"],
            "output_tok_s": out_tokens / (run.state["drained"]
                                          - run.state["start"]),
            "preempted": (run.state["stats1"]["scheduler"]["preempted"]
                          - run.state["stats0"]["scheduler"]["preempted"]),
        }
        print(json.dumps(line), flush=True)
    client.release(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
