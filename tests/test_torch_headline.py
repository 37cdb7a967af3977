"""bench/headline.py, the port's counterpart of the root bench.py: its
floor against bench.py's arithmetic over the JAX package's KV sizing, its
median rule, and its one JSON line with bench.py's keys (a CPU run at a
toy size, the card's spec injected: no device number comes of it)."""
import json
import types

import pytest
import torch

from physics_llm_inference_tpu.models.config import ModelConfig as JConfig
from physics_llm_inference_tpu.runtime.kv_cache import \
    calculate_kv_cache_size as j_kv_size
from physics_llm_inference_tpu_torch.bench import headline
from physics_llm_inference_tpu_torch.models.config import \
    ModelConfig as TConfig
from physics_llm_inference_tpu_torch.specs.gpu import H100_SXM

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "ttft_p50_ms"}
TINY = dict(hidden_dim=64, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_dim=128)


@pytest.mark.parametrize("model,batch,wbits", [("7b", 64, 8), ("7b", 64, 4),
                                               ("0.85b", 128, 8)])
def test_floor_is_bench_py_arithmetic(model, batch, wbits):
    shapes = headline.SHAPES[model]
    common = dict(vocab_size=32000, max_seq_len=2048, dtype="bfloat16",
                  **shapes)
    jcfg, tcfg = JConfig(**common), TConfig(**common)
    # bench.py:115-125 with the card's bandwidth
    kv = j_kv_size(batch, 128 + 128, jcfg.num_layers, jcfg.num_kv_heads,
                   jcfg.head_dim, 1)
    floor = (jcfg.param_count() * wbits // 8 + kv["total_bytes"]) \
        / H100_SXM.hbm_bandwidth
    got = headline.speed_of_light_tok_s(tcfg, batch, 128, 128, wbits,
                                        H100_SXM)
    assert got == pytest.approx(batch / floor, rel=1e-12)


def test_median_run_is_bench_py_rule():
    outs = [types.SimpleNamespace(decode_tokens_per_s=v, prefill_s=i)
            for i, v in enumerate((5.0, 1.0, 4.0, 2.0, 3.0))]
    assert headline.median_run(outs).decode_tokens_per_s == 3.0
    assert headline.median_run(outs).prefill_s == 4


def test_main_prints_bench_py_line(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_BATCH", "8")
    for name in ("BENCH_MODEL", "BENCH_ATTN", "BENCH_ACT", "BENCH_WBITS"):
        monkeypatch.delenv(name, raising=False)
    runs = []
    real = headline.cached_generate

    def spy(*a, **kw):
        out = real(*a, **kw)
        runs.append(out)
        return out

    monkeypatch.setattr(headline, "cached_generate", spy)
    res = headline.main(device="cpu", shapes={"7b": TINY}, spec=H100_SXM)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == res
    assert set(res) == BENCH_KEYS
    assert len(runs) == 1 + headline.RUNS      # one warm run, then five
    med = headline.median_run(runs[1:])
    assert res["value"] == round(med.decode_tokens_per_s, 1)
    assert res["ttft_p50_ms"] == round(med.prefill_s * 1e3, 1)
    cfg = TConfig(vocab_size=32000, max_seq_len=2048, **TINY)
    sol = headline.speed_of_light_tok_s(cfg, 8, 128, 128, 8, H100_SXM)
    assert res["vs_baseline"] == round(med.decode_tokens_per_s / sol, 4)
    assert all(o.tokens.shape == (8, 128) for o in runs)
    torch.testing.assert_close(torch.from_numpy(runs[1].tokens),
                               torch.from_numpy(runs[0].tokens))
