"""Readings for a cell's correctness limit: the program's widest logit gap
and the control's (the reference with int4 weights), seed by seed, in one
process on the card, each seed a whole run of the cell (its own weights,
set-up and window).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--control 1] [--witness 0]

One JSON line a seed: the checks, the end-to-end metrics, set-up.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run as bench  # noqa: E402


def readings(workload: str, seeds: list, seconds: float, control: bool,
             device="cuda", root: Path = bench.ROOT, witness: bool = False):
    """Yield one run's result per seed, each with `seed` added."""
    import torch

    for seed in seeds:
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res = bench.run_cell(root, workload, seed, seconds, False, device,
                             started=time.time(), control=control,
                             witness=witness)
        res["seed"] = seed
        yield res
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--witness", type=int, default=0,
                    help="also read the reference computed in bf16")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    for res in readings(args.workload, seeds, args.seconds,
                        bool(args.control), witness=bool(args.witness)):
        line = {"seed": res["seed"], "correct": res["correct"],
                "checks": res["checks"], "metrics": res["metrics"],
                "attempted": res["attempted"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
