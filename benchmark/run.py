"""The benchmark of the PyTorch/CUDA port: one cell, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (an entry of BENCHMARK.json's `workloads`) names a configuration
and a traffic mix; each is a file of its own, as are the configuration's
architecture module, the mix's client and every metric's reader
(lib/spec.py). The run makes the weights from the seed on the card, sets
up the client (build, capture, warm-up: `setup_s` counts from the
process's start), runs the window, then judges what the window produced
against the architecture's plain reference (lib/judge.py) and reads the
cell's metrics: the end-to-end ones, or with `--trace 1` the per-layer
ones from a profiled slice. The last line of standard output is one JSON
object; the compared numbers and their limits are the last lines of
standard error and the result's last key. Without CUDA, or with fewer
cards than the cell asks for, it exits 2 and prints no result; it exits 3
if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _process_start() -> float:
    """time.time() at which this process started (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


T_START = _process_start()
# every build and kernel cache of the program at fixed paths in the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "physics_llm_inference_tpu")


class Run:
    """One run's inputs and what its client and the judge leave for the
    metric readers."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device = trace, device
        self.config, self.mix = cell.config, cell.traffic
        self.state: dict = {}
        self.slice = None
        self.attempted = self.failed = 0

    @staticmethod
    def log(*a) -> None:
        print("[benchmark]", *a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _device_info(run, torch) -> dict:
    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
            "count": run.cell.chips,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(run.device)}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, started: float | None = None,
             control: bool = False, witness: bool = False) -> dict:
    """One run of `workload` on `device`; returns the result object (with
    `control` also the control's readings, and with `witness` the bf16
    witness's, under `checks`). Raises
    SystemExit(3) if JAX or the JAX package is loaded after the window."""
    import torch

    from benchmark.lib import arith, judge, spec
    from benchmark.lib.trace import Profiler

    started = T_START if started is None else started
    cell = spec.load_cell(root, workload)
    device = torch.device(device)
    torch.manual_seed(seed % (1 << 63))
    arch = spec.arch(root, cell.config)
    run = Run(cell, seed, seconds, trace, device)
    run.cfg = arch.model_config(cell.config)
    w = arch.weights(cell.config, seed, device)
    run.work = arch.Work(cell.config, arch.weight_bytes(w))
    run.params = arch.program_params(w)
    client = spec.client(root, cell.traffic["client"])
    client.setup(run)
    if trace:
        # the first profile of a process initializes the device tracer for
        # seconds: do it here, not in the window
        prof = Profiler(device)
        prof.start()
        prof.stop()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.setup_s = time.time() - started
    client.window(run)
    bad = forbidden_modules()
    if bad:
        print(f"[benchmark] loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        raise SystemExit(3)
    dev_info = _device_info(run, torch)
    run.e2e = client.end_to_end(run)
    picked = client.samples(run)
    client.release(run)
    run.params = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = judge.gaps(arch.logits, w, cell.config, picked, control=control,
                     witness=witness)
    run.peaks = arith.peaks(dev_info["kind"])
    checks = {name: {"value": got[name], "limit": limit}
              for name, limit in cell.limits["limits"].items()}
    checks.update({
        "missing": {"value": run.failed, "limit": 0},
        "short": {"value": sum(len(s["tokens"]) != s["expected"]
                               for s in picked), "limit": 0}})
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev_info}
    if trace and run.slice is not None:
        dev_info["busy_s"] = run.slice.busy_s()
        dev_info["window_s"] = run.slice.window_s()
        result["breakdown"] = {"device_ops": run.slice.top_ops(),
                               "idle_gaps": run.slice.idle_gaps()}
    if control or witness:
        checks["readings"] = dict(got)
    if control:
        for name, limit in cell.limits["limits"].items():
            checks["control." + name] = {
                "value": got[name.replace("logit_gap", "control_gap")],
                "limit": limit}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from benchmark.lib import spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"[benchmark] {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda")
    for name, c in result["checks"].items():
        print(f"[benchmark] check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
