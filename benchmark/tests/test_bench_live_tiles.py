"""The reader of `expert_live_tile_share.decode`: the share of m16 tiles
the grouped expert kernels ran over the decode, read from the attributes
of the traced batch's `generate.decode` span; nothing where the program
keeps no such counter."""
import json

import pytest

from benchmark.lib.spec import metric_reader
from benchmark.tests import toy
from benchmark.tests.test_bench_deepseek import (CELL, PHASES, REPO, TOY,
                                                 _run, _traced)


def test_expert_live_tile_share_reads_the_decode_span():
    decode = ("generate.decode", 4_000, 9_000,
              {"rows": 2, "expert_tiles_live": 70, "expert_tiles": 256})
    late = [("generate.decode", 9_500, 9_600,
             {"expert_tiles_live": 1, "expert_tiles": 1})]
    reader = metric_reader(REPO, "expert_live_tile_share.decode")
    run = _traced([], [PHASES[0], decode] + late)
    assert reader.read(run) == pytest.approx(100 * 70 / 256)
    # a program whose decode span holds no tiles (the kernels never ran, or
    # it keeps no counter), or no span: nothing, and no exception
    run = _traced([], [PHASES[0], ("generate.decode", 4_000, 9_000,
                                   {"rows": 2})])
    assert reader.read(run) is None
    run = _traced([], [PHASES[0], ("generate.decode", 4_000, 9_000,
                                   {"expert_tiles_live": 0,
                                    "expert_tiles": 0})])
    assert reader.read(run) is None
    assert reader.read(_traced([], [])) is None


def test_a_traced_toy_run_reads_the_live_tile_share(tmp_path):
    """The toy DeepSeek cell with the live-tile reader in its traced line:
    the port's decode (the grouped route's plain version on the CPU) counts
    its tiles, and the share lies in (0, 100]."""
    root = toy.make_root(tmp_path)
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "toy_ds", "source": "a test", "reduced": [],
                         "file": "benchmark/configs/toy_ds.json"})
    s["workloads"].append({"name": CELL, "config": "toy_ds",
                           "traffic": "toy_offline", "chips": 1,
                           "why": "a test"})
    s["end_to_end"][0]["workloads"].append(CELL)
    s["per_layer"].append({"name": "expert_live_tile_share.decode",
                           "unit": "%", "better": "higher",
                           "source": "program_counter", "layer": "model step",
                           "moves": "output_tok_s", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    (root / "benchmark" / "configs" / "toy_ds.json").write_text(
        json.dumps(TOY))
    (root / "benchmark" / "cells" / f"{CELL}.json").write_text(json.dumps(
        {"limits": {"logit_gap_max": toy.LIMIT,
                    "logit_gap_mean": toy.MEAN_LIMIT}}))
    res = _run(root, trace=True)
    assert res["correct"], res["checks"]
    share = res["metrics"]["expert_live_tile_share.decode"]["value"]
    assert 0 < share <= 100
