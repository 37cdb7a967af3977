"""The port's utils (profiling, logging) and specs/plot against the JAX
package's: tests/test_utils.py's cases, the logger's lines equal to the JAX
logger's for the same events (timestamps aside), and plot_roofline's
series equal to the JAX function's on the port's GPUSpec (exact)."""
import io
import json
import os

import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.specs.plot import \
    plot_roofline as jax_plot_roofline
from physics_llm_inference_tpu.utils.logging import \
    get_logger as jax_get_logger
from physics_llm_inference_tpu_torch.specs.gpu import H100_SXM
from physics_llm_inference_tpu_torch.specs.plot import plot_roofline
from physics_llm_inference_tpu_torch.utils import profiling
from physics_llm_inference_tpu_torch.utils.logging import get_logger
from physics_llm_inference_tpu_torch.utils.timing import benchmark_fn


class TestTiming:
    def test_benchmark_fn_schema(self):
        r = benchmark_fn(lambda x: x + 1, torch.ones((8, 8)), warmup=1,
                         iters=3, name="add")
        assert r.iters == 3 and r.mean_ms > 0
        d = r.to_dict()
        assert {"name", "mean_ms", "std_ms", "min_ms", "max_ms"} <= set(d)
        assert "add" in str(r)


class TestLogging:
    def test_json_lines(self):
        buf = io.StringIO()
        log = get_logger("engine", stream=buf)
        log.info("request_done", rid="r1", tokens=5)
        rec = json.loads(buf.getvalue())
        assert rec["component"] == "engine" and rec["tokens"] == 5

    def test_level_filtering(self):
        buf = io.StringIO()
        log = get_logger("x", level="warn", stream=buf)
        log.info("hidden")
        log.error("shown")
        lines = buf.getvalue().strip().splitlines()
        assert len(lines) == 1 and json.loads(lines[0])["event"] == "shown"

    def test_text_mode(self):
        buf = io.StringIO()
        log = get_logger("x", json_mode=False, stream=buf)
        log.info("hello", a=1)
        assert "hello a=1" in buf.getvalue()

    @pytest.mark.parametrize("json_mode", [True, False])
    @pytest.mark.parametrize("level", ["debug", "info", "warn", "error"])
    def test_lines_equal_the_jax_loggers(self, json_mode, level):
        events = [("debug", "d", {}), ("info", "request_done",
                                       {"rid": "r1", "tokens": 5}),
                  ("warn", "slow", {"ms": 12.5, "path": None}),
                  ("error", "failed", {"obj": object.__name__,
                                       "xs": [1, 2]})]
        out = []
        for make in (get_logger, jax_get_logger):
            buf = io.StringIO()
            log = make("engine", level=level, json_mode=json_mode,
                       stream=buf)
            for lvl, ev, f in events:
                getattr(log, lvl)(ev, **f)
            lines = buf.getvalue().splitlines()
            if json_mode:
                lines = [{k: v for k, v in json.loads(s).items()
                          if k != "ts"} for s in lines]
            out.append(lines)
        assert out[0] == out[1] and len(out[0]) == \
            4 - ["debug", "info", "warn", "error"].index(level)


class TestProfiling:
    def test_dispatch_overhead_schema(self):
        out = profiling.dispatch_overhead(iters=5, device="cpu")
        assert out["synced_us_per_dispatch"] > 0
        assert out["pipelined_us_per_dispatch"] > 0
        # no device time is measured on the CPU
        assert out["device"] == "cpu" and "device_us_per_launch" not in out

    def test_fusion_benefit_schema(self):
        out = profiling.fusion_benefit(n_ops=4, size=1 << 14, iters=3,
                                       device="cpu")
        assert out["fused_ms"] > 0 and out["unfused_ms"] > 0
        assert out["fused_form"].startswith("eager")

    def test_memory_stats_no_crash(self):
        out = profiling.device_memory_stats()
        assert "available" in out
        assert profiling.device_memory_stats("cpu") == {"available": False}

    def test_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiling.dispatch_overhead(iters=2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiling.fusion_benefit(iters=1)

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with profiling.trace(str(tmp_path / "t")) as d:
            torch.ones(64).sum()
        with open(os.path.join(d, "trace.json")) as f:
            assert "traceEvents" in json.load(f)


@pytest.mark.parametrize("dtype", ["bf16", "int8", "fp32"])
def test_plot_roofline_series_equal_the_jax_functions(dtype, tmp_path):
    points = {"decode gemv": 1.0, "prefill gemm": 300.0}
    got = plot_roofline(H100_SXM, points, dtype,
                        save_path=str(tmp_path / "r.png"))
    want = jax_plot_roofline(H100_SXM, points, dtype)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert (tmp_path / "r.png").stat().st_size > 0
