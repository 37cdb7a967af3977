"""Finding a cell's files by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file is the one `configs` gives; the mix is
`benchmark/traffic/<traffic>.json`, whose `client` names
`benchmark/clients/<client>.py`; the cell's correctness limits are
`benchmark/cells/<workload>.json`; each metric is read by
`benchmark/metrics/<metric>.py`. A later cell, mix, client or metric is
added as files and entries, without editing any file here. Each file is
looked for under the root's `benchmark/` first, then beside this module
(the same folder in a checkout; a test's root holds only its new files).
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


def metric_reader(root: Path, name: str):
    return load_module(find(root, "metrics", f"{name}.py"),
                       "benchmark_metric_" + name.replace(".", "_"))
