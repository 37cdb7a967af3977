"""A cell added from new files alone runs end to end on the CPU with the
port's plain kernels; the result line is well formed; nothing the run
imports is JAX or the JAX package; and each fault a cell can have, planted
in the timed path underneath, makes `correct` false."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import run as bench
from benchmark.tests import toy

REPO = Path(__file__).resolve().parent.parent.parent
CELLS = ["toy.decode", "toy_moe.decode", "toy.serve"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.make_root(tmp_path_factory.mktemp("toy"))


def _run(root, cell, trace=False, seed=2**31 + 5, control=False):
    return bench.run_cell(root, cell, seed, 1.5, trace, "cpu",
                          started=time.time(), control=control)


def _well_formed(res, spec, cell, trace):
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec[kind]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    for name, m in line["metrics"].items():
        assert isinstance(m["value"], (int, float)), name
    for c in line["checks"].values():
        assert {"value", "limit"} == set(c)
    assert {"logit_gap_max", "logit_gap_mean", "missing", "short"} == \
        set(line["checks"])
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_toy_cell_from_new_files_runs_and_is_correct(root, cell, trace):
    res = _run(root, cell, trace)
    _well_formed(res, toy.SPEC, cell, trace)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_limit(root, cell):
    res = _run(root, cell, control=True, seed=11)
    c = res["checks"]
    assert res["correct"]
    assert c["control.logit_gap_max"]["value"] > toy.LIMIT
    assert c["control.logit_gap_mean"]["value"] > toy.MEAN_LIMIT


def _altered_token(mp, cell):
    """The token a step produces, plus one."""
    if cell == "toy.serve":
        from physics_llm_inference_tpu_torch.models import paged_transformer

        orig = paged_transformer.sample_token
        mp.setattr(paged_transformer, "sample_token",
                   lambda logits, *a, **k: (orig(logits, *a, **k) + 1)
                   % logits.shape[-1])
    else:
        from physics_llm_inference_tpu_torch.runtime import generate

        orig = generate.forward

        def forward(params, ids, cfg, **kw):
            out, kv = orig(params, ids, cfg, **kw)
            if kw.get("greedy_head"):
                out = (out + 1) % cfg.vocab_size
            return out, kv
        mp.setattr(generate, "forward", forward)


def _state_unchanged(mp, cell):
    """A decode step that returns its state as it found it."""
    if cell == "toy.serve":
        from physics_llm_inference_tpu_torch.serve import paged_engine

        orig = paged_engine.paged_decode_scan_impl

        def scan(params, tokens, *a, horizon=1, **k):
            _, kp, vp = orig(params, tokens, *a, horizon=horizon, **k)
            return tokens[:, None].expand(-1, horizon).to(torch.int32), kp, vp
        mp.setattr(paged_engine, "paged_decode_scan_impl", scan)
    else:
        from physics_llm_inference_tpu_torch.runtime import generate

        orig = generate.DecodeLoop.step

        def step(self):
            tok = self.tok.clone()
            orig(self)
            self.tok.copy_(tok)
        mp.setattr(generate.DecodeLoop, "step", step)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged])
def test_a_fault_in_the_timed_path_is_not_correct(root, cell, fault,
                                                  monkeypatch):
    fault(monkeypatch, cell)
    res = _run(root, cell)
    assert not res["correct"], res["checks"]
    assert res["checks"]["logit_gap_max"]["value"] > toy.LIMIT


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "physics_llm_inference_tpu_torch.x", sys)
    assert "jax" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert bench.forbidden_modules()[0] == "jax"


def test_a_run_imports_neither_jax_nor_the_jax_package(root):
    code = ("import sys, time, json; sys.path.insert(0, %r)\n"
            "from pathlib import Path\n"
            "from benchmark import run\n"
            "res = run.run_cell(Path(%r), 'toy.serve', 3, 1.0, False, 'cpu',"
            " started=time.time())\n"
            "run.run_cell(Path(%r), 'toy_moe.decode', 3, 1.0, True, 'cpu',"
            " started=time.time())\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % (str(REPO), str(root), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(root))
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "physics_llm_inference_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "physics_llm_inference_tpu"}


def test_without_cuda_the_command_prints_no_result(root):
    out = subprocess.run(
        [sys.executable, str(REPO / "benchmark" / "run.py"), "--workload",
         "mistral7b.decode", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
