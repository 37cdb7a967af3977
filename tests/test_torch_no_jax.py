"""The port imports torch and numpy, never jax."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import physics_llm_inference_tpu_torch as port

ROOT = Path(__file__).resolve().parent.parent


def _modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        names.append(info.name)
    return names


def test_walk_finds_every_module():
    names = _modules()
    for expected in ("models.transformer", "kernels.int8_matmul",
                     "kernels.int8_kv_attention", "kernels.lmhead",
                     "kernels.fused_decode", "kernels.flash_attention",
                     "runtime.generate", "convert", "specs.gpu",
                     "kernels.paged_attention", "models.paged_transformer",
                     "runtime.paged_kv", "runtime.radix_cache", "native",
                     "sched.request", "sched.scheduler", "serve.engine",
                     "serve.paged_engine", "kernels.matmul",
                     "kernels.membench", "kernels.hello_pallas",
                     "specs.roofline", "utils.timing", "ops.ffn",
                     "sched.static_batcher", "bench.micro", "bench.suite",
                     "models.quant", "bench.headline", "runtime.step_cache",
                     "serve.api_types", "serve.tokenizer_pool",
                     "serve.http_server", "bench.harness",
                     "runtime.speculative", "cli", "serve.lifecycle",
                     "models.moe", "models.moe_inference", "bench.moe"):
        assert f"{port.__name__}.{expected}" in names


def test_no_module_imports_jax():
    code = ("import importlib, sys\n"
            f"for name in {_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m.startswith('physics_llm_inference_tpu.')\n"
            "             or m == 'physics_llm_inference_tpu')\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
