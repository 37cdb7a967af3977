"""A configuration brings its architecture as a file: a root that adds
`benchmark/arch/<model_type>.py` beside its configuration, mix and cell
runs through `run_cell` without an edit to any file of the harness; the
judge reads that module's reference and the metric readers its counts;
a `model_type` with no module stops the run naming the missing file."""
import json
import re
import time
import types

import pytest

from benchmark import run as bench
from benchmark.arch import mistral
from benchmark.lib import spec
from benchmark.lib.arith import ideal_s
from benchmark.lib.trace import Slice
from benchmark.tests import toy
from benchmark.tests.test_bench_arith import PEAKS

REUSE = ("from benchmark.arch import mistral\n"
         "from benchmark.arch.mistral import (Work, logits, model_config,\n"
         "    program_params, weight_bytes, weights)\n")
MODULES = {
    # mistral's functions under a model_type of its own
    "toy_variant": REUSE,
    # the reference alone rotates by another theta
    "toy_perturbed": REUSE + (
        "def logits(w, config, *a, **k):\n"
        "    return mistral.logits(\n"
        "        w, dict(config, rope_theta=config['rope_theta'] / 100),\n"
        "        *a, **k)\n"),
    # a decode step's bytes counted twice
    "toy_doubled": REUSE + (
        "class Work(mistral.Work):\n"
        "    def decode(self, contexts):\n"
        "        flops, nbytes = super().decode(contexts)\n"
        "        return flops, 2 * nbytes\n"),
}
CELLS = {f"{kind}.decode": kind for kind in [*MODULES, "toy_absent"]}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = toy.make_root(tmp_path_factory.mktemp("arch"))
    s = json.loads((root / "BENCHMARK.json").read_text())
    for cell, kind in CELLS.items():
        s["configs"].append({"name": kind, "source": "a test",
                             "reduced": [],
                             "file": f"benchmark/configs/{kind}.json"})
        s["workloads"].append({"name": cell, "config": kind,
                               "traffic": "toy_offline", "chips": 1,
                               "why": "a test"})
        (root / "benchmark" / "configs" / f"{kind}.json").write_text(
            json.dumps(dict(toy.CONFIG, model_type=kind)))
        (root / "benchmark" / "cells" / f"{cell}.json").write_text(
            json.dumps({"limits": {"logit_gap_max": toy.LIMIT,
                                   "logit_gap_mean": toy.MEAN_LIMIT}}))
        s["end_to_end"][0]["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    arch = root / "benchmark" / "arch"
    arch.mkdir()
    for kind, code in MODULES.items():
        (arch / f"{kind}.py").write_text(code)
    return root


def _run(root, cell, seed=2**31 + 9):
    return bench.run_cell(root, cell, seed, 1.5, False, "cpu",
                          started=time.time())


def test_a_new_architecture_as_files_runs_and_is_correct(root):
    res = _run(root, "toy_variant.decode")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and "output_tok_s" in res["metrics"]


def test_the_judge_reads_the_modules_reference(root):
    res = _run(root, "toy_perturbed.decode")
    assert not res["correct"], res["checks"]
    assert res["checks"]["logit_gap_max"]["value"] > toy.LIMIT


def test_the_readers_get_the_modules_counts(root, monkeypatch):
    seen = []
    real = spec.metric_reader

    def reader(r, name):
        got = real(r, name)
        return types.SimpleNamespace(
            read=lambda run: seen.append(run.work) or got.read(run))
    monkeypatch.setattr(spec, "metric_reader", reader)
    res = _run(root, "toy_doubled.decode")
    assert res["correct"], res["checks"]
    work = seen[0]
    plain = mistral.Work(toy.CONFIG, work.wb)
    assert type(work).__name__ == "Work" and type(work) is not mistral.Work
    assert work.decode([3, 5]) == (plain.decode([3, 5])[0],
                                   2 * plain.decode([3, 5])[1])
    # mfu.offline over a synthetic traced batch of two rows, 3 new tokens
    lens, wall_ns = [3, 5], 10_000
    run = types.SimpleNamespace(
        peaks=PEAKS, work=work, log=lambda *a: None, mix={"new_tokens": 3},
        slice=Slice(t0=0, t1=wall_ns, device=[(0, 100, "k")], host=[]),
        state={"batches": [{"traced": True,
                            "prompts": [[1] * n for n in lens],
                            "host_ns": (0, wall_ns)}]})
    ideal = ideal_s(*plain.prefill([(0, n) for n in lens]), PEAKS)[0]
    for i in range(2):
        flops, nbytes = plain.decode([n + i for n in lens])
        ideal += ideal_s(flops, 2 * nbytes, PEAKS)[0]
    mfu = spec.metric_reader(root, "mfu.offline").read(run)
    assert mfu == pytest.approx(100 * ideal / (wall_ns / 1e9))
    run.work = plain
    assert spec.metric_reader(root, "mfu.offline").read(run) < mfu


@pytest.mark.parametrize("model_type", ["toy_absent", None])
def test_a_model_type_without_a_module_names_the_missing_file(tmp_path,
                                                              model_type):
    config = {k: v for k, v in toy.CONFIG.items() if k != "model_type"}
    if model_type:
        config["model_type"] = model_type
    want = f"benchmark/arch/{model_type or '<model_type>'}.py"
    with pytest.raises(SystemExit, match=re.escape(want)):
        spec.arch(tmp_path, config)


def test_a_run_of_a_model_type_without_a_module_stops(root):
    with pytest.raises(SystemExit, match="benchmark/arch/toy_absent.py"):
        _run(root, "toy_absent.decode")
