"""Finding a cell's files by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file is the one `configs` gives; the mix is
`benchmark/traffic/<traffic>.json`, whose `client` names
`benchmark/clients/<client>.py`; the cell's correctness limits are
`benchmark/cells/<workload>.json`; each metric is read by
`benchmark/metrics/<metric>.py`; the configuration file's `model_type`
names its architecture, `benchmark/arch/<model_type>.py`. A later cell,
mix, client, metric or architecture is added as files and entries,
without editing any file here. Each file is looked for under the root's
`benchmark/` first, then beside this module (the same folder in a
checkout; a test's root holds only its new files).

An architecture module provides, for a configuration file's contents
`config` (Hugging Face keys with `precision` and `assumed`):

- `model_config(config)`: the port's `ModelConfig`.
- `weights(config, seed, device) -> w`: the weights made from the seed on
  the device (lib/weights.py), plain tensors under the architecture's own
  names. The same seed gives the same tensors.
- `program_params(w)`: the port's parameter dict over the same tensors.
- `weight_bytes(w) -> wbytes`: the weights' bytes by part, for `Work`.
- `Work(config, wbytes)`: the operations and compulsory bytes the metric
  readers use: `decode(contexts)` and `prefill(chunks)` give (FLOPs,
  bytes) of a whole step or None where the count needs the program's
  routing; `fused_decode_bytes(contexts)`, `prefill_linear_flops(chunks)`,
  `expert_bytes(rows)`, `experts_touched(rows)`,
  `layer_weight_bytes(rows)`; the attributes `L` (layers), `d` (hidden
  size) and `e` (routed experts, 0 for none).
- `logits(w, config, seqs, positions, int4=False, bf16=False)`: the plain
  float32 reference (lib/judge.py), from `w` alone and importing nothing
  of the port; `int4=True` is the control, the precision below the
  stated one, and `bf16=True` the bf16 witness (lib/plain.py).
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    config_name: str
    traffic: dict         # the mix file's contents
    traffic_name: str
    limits: dict          # benchmark/cells/<name>.json
    end_to_end: list      # the metric entries this cell reports
    per_layer: list


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find(root: Path, *parts: str) -> Path:
    """`benchmark/<parts>` under `root`, else beside this module."""
    for base in (root / "benchmark", BENCH_DIR):
        path = base.joinpath(*parts)
        if path.exists():
            return path
    raise SystemExit(f"no file benchmark/{'/'.join(parts)}")


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json with its files."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have: {', '.join(sorted(cells))})")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(find(root, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    with open(find(root, "cells", f"{workload}.json")) as f:
        limits = json.load(f)
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                config_name=w["config"], traffic=traffic,
                traffic_name=w["traffic"], limits=limits,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, workload)])


def load_module(path: Path, name: str):
    """A module from its file (a metric's name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def client(root: Path, name: str):
    return load_module(find(root, "clients", f"{name}.py"),
                       f"benchmark_client_{name}")


def arch(root: Path, config: dict):
    """The architecture module `benchmark/arch/<model_type>.py` of a
    configuration file's contents."""
    kind = config.get("model_type")
    if not kind:
        raise SystemExit("the configuration has no model_type, so no "
                         "benchmark/arch/<model_type>.py")
    return load_module(find(root, "arch", f"{kind}.py"),
                       f"benchmark_arch_{kind}")


def metric_reader(root: Path, name: str):
    return load_module(find(root, "metrics", f"{name}.py"),
                       "benchmark_metric_" + name.replace(".", "_"))
