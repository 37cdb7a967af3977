"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its file."""
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent.parent
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}
WIDTH = re.compile(r"(_size$|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|expansion|experts_per_tok)")


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its 43,200 s
    assert 338 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("kind", list(KEYS))
def test_entries(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        assert set(e) <= KEYS[kind] and NAME.match(e["name"]), e
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                               "higher")


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    used = set()
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        used.add(w["config"])
        assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json"
                ).exists()
        assert (REPO / "benchmark" / "cells" / f"{w['name']}.json").exists()
        e2e = [m for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in SPEC["per_layer"])
    assert used == set(configs)
    for c in configs.values():
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"])


def test_metrics_have_readers_and_move_what_their_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in list(e2e.values()) + SPEC["per_layer"]:
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    layers = {}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(layers) == {"serving front", "offline entry", "model step",
                           "kernels", "device"}
