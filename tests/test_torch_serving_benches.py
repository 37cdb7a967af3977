"""bench/serving7b and bench/speculative (the ports of
scripts/bench_serving7b.py and scripts/bench_speculative.py): their prompts
against the scripts' draws from the same seed (exact), and each `main` at a
toy size on the CPU with the scripts' JSON keys."""
import numpy as np
import pytest

from physics_llm_inference_tpu_torch.bench import serving7b, speculative
from physics_llm_inference_tpu_torch.models.config import ModelConfig

TOY = dict(vocab_size=512, hidden_dim=128, num_layers=2, num_heads=2,
           num_kv_heads=1, intermediate_dim=256, dtype="float32")
# the keys of docs/artifacts/serving7b_r5_*.json and speculative rows
SERVING_KEYS = {"num_requests", "total_time_s", "requests_per_s",
                "tokens_per_s", "latency", "ttft", "metric",
                "radix_hit_tokens", "radix_hit_tokens_incl_warm",
                "preemptions", "tunnel_rtt_ms", "config"}
ROW_KEYS = {"case", "k", "wall_s", "tokens", "tok_per_s",
            "tokens_per_dispatch", "dispatches"}


def _script_serving_prompts(seed, vocab, block, prompt, order):
    """bench_serving7b.py:62-75 as written, prompt_fn called in `order`."""
    rng = np.random.default_rng(seed)
    shared = [list(rng.integers(1, vocab, block)) for _ in range(8)]

    def prompt_fn(i):
        if i % 4 == 0 and prompt > block:
            pre = shared[(i // 4) % len(shared)]
            return pre + list(rng.integers(1, vocab, prompt - len(pre)))
        return list(rng.integers(1, vocab, prompt))

    return [prompt_fn(i) for i in order]


@pytest.mark.parametrize("prompt,block", [(576, 512), (128, 512),
                                          (40, 16)])
def test_serving7b_prompts_are_the_scripts(prompt, block):
    n = 24
    # the script's harness: requests 0 and 1 one by one, the warm wave's
    # 0 .. n - 1, then the timed wave's 0 .. n - 1
    order = [0, 1] + list(range(n)) + list(range(n))
    want = _script_serving_prompts(0, 32000, block, prompt, order)
    p = serving7b.Prompts(np.random.default_rng(0), 32000, block, prompt)
    got = p.wave(0, 2) + p.wave(0, n) + p.wave(0, n)
    assert [list(map(int, x)) for x in got] == \
        [list(map(int, x)) for x in want]
    assert all(len(x) == prompt for x in got)
    if prompt > block:
        assert got[2][:block] == got[2 + n][:block]   # a shared prefix


@pytest.mark.parametrize("slots,prompt", [(8, 128), (3, 40)])
def test_speculative_prompts_are_the_scripts(slots, prompt):
    rng = np.random.default_rng(0)                 # bench_speculative.py:71-77
    pat = list(rng.integers(1, 32000, 16))
    rep = [(pat * (prompt // 16 + 1))[:prompt] for _ in range(slots)]
    rnd = [list(rng.integers(1, 32000, prompt)) for _ in range(slots)]
    got_rep, got_rnd = speculative.prompts(np.random.default_rng(0), 32000,
                                           slots, prompt)
    assert got_rep == rep and got_rnd == rnd


def test_serving7b_main_keys_at_a_toy_size():
    out = serving7b.main(["--requests", "4", "--concurrency", "2",
                          "--decode", "2", "--batch", "4"], device="cpu",
                         cfg=ModelConfig(max_seq_len=1024, **TOY))
    assert SERVING_KEYS <= set(out)
    assert out["num_requests"] == 4 and out["tokens_per_s"] > 0
    assert out["tunnel_rtt_ms"] == {"before": None, "after": None}
    assert out["config"] == {"batch": 4, "block_size": 512, "horizon": 8,
                             "concurrency": 2, "requests": 4, "prompt": 576,
                             "decode": 2}
    # the timed wave repeats the warm wave's prompts: its shared prefix is
    # cached
    assert out["radix_hit_tokens"] > 0
    assert out["preemptions"] >= 0 and out["device"] == "cpu"


def test_speculative_main_keys_at_a_toy_size():
    out = speculative.main(["--slots", "2", "--prompt", "32", "--decode",
                            "6"], device="cpu",
                           cfg=ModelConfig(max_seq_len=512, **TOY))
    assert out["metric"] == "speculative_7b"
    assert [(r["case"], r["k"]) for r in out["rows"]] == [
        ("repetitive", 0), ("repetitive", 4), ("realistic", 0),
        ("realistic", 4)]
    for r in out["rows"]:
        assert ROW_KEYS <= set(r) and r["tokens"] == 12
        assert (r["dispatches"] > 0) == (r["k"] > 0)
        assert r["tokens_per_dispatch"] >= 1.0
    # greedy speculation emits the plain engine's tokens
    for a, b in ((0, 1), (2, 3)):
        assert out["rows"][a]["outputs"] == out["rows"][b]["outputs"]
