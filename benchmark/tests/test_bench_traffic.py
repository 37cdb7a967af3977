"""The traffic generators: the same seed gives the same inputs, other
seeds the same sizes in another order."""
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.clients import open_loop
from benchmark.lib import traffic

MIXES = Path(__file__).resolve().parent.parent / "traffic"
BIG_SEED = 2**31 + 12345


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["offline_b64_p128-512_n512",
                                  "offline_b64_p64-256_n128"])
def test_offline_batches_repeat_from_the_seed(name):
    mix = _mix(name)
    a = traffic.offline_batch(mix, 32000, BIG_SEED, 3)
    assert a == traffic.offline_batch(mix, 32000, BIG_SEED, 3)
    b = traffic.offline_batch(mix, 32000, BIG_SEED + 1, 3)
    assert a != b
    assert sorted(map(len, a)) == sorted(map(len, b))
    assert len(a) == mix["batch"]
    lens = [len(p) for p in a]
    assert min(lens) >= mix["prompt"]["min"]
    assert max(lens) <= min(mix["prompt"]["max"], mix["prompt_bucket"])
    assert all(1 <= t < 32000 for p in a for t in p)


def test_open_loop_repeats_from_the_seed_with_the_same_sizes():
    mix = _mix("chat_poisson")
    a = traffic.open_loop(mix, 32768, BIG_SEED, 30.0)
    assert a == traffic.open_loop(mix, 32768, BIG_SEED, 30.0)
    b = traffic.open_loop(mix, 32768, -7, 30.0)
    assert [r["prompt"] for r in a] != [r["prompt"] for r in b]
    key = lambda rs: sorted((len(r["prompt"]), r["max_tokens"],
                             r["shared"] is not None) for r in rs)
    assert key(a) == key(b)
    gaps = lambda rs: sorted(np.round(np.diff([0.0] + [r["due"] for r in rs]),
                                      9))
    assert gaps(a) == gaps(b)
    assert len(a) == round(mix["rate_rps"] * 30)
    assert 0 < a[0]["due"] and a[-1]["due"] < 30.0
    sh = mix["shared"]
    for r in a:
        assert len(r["prompt"]) + r["max_tokens"] <= 1024
        if r["shared"] is not None:
            assert len(r["prompt"]) <= sh["max_prompt"]
            assert len(r["prompt"]) > sh["prefix_len"]
    shared = [r for r in a if r["shared"] is not None]
    assert len(shared) == -(-len(a) // sh["every"])
    pre = {tuple(r["prompt"][:sh["prefix_len"]]) for r in shared}
    assert len(pre) == sh["prefixes"]


def test_quantiles_by_hand():
    assert traffic.quantiles({"dist": "uniform", "min": 10, "max": 13},
                             4).tolist() == [10, 11, 12, 13]
    q = traffic.quantiles({"dist": "lognormal", "median": 100, "sigma": 1.0,
                           "min": 1, "max": 10**6}, 3)
    assert q[1] == 100
    e = traffic.quantiles({"dist": "exponential", "mean": 2.0}, 2)
    assert e == pytest.approx([-2 * np.log(0.75), -2 * np.log(0.25)])


def test_prefill_shapes_cover_every_chunk_the_engine_can_batch():
    from physics_llm_inference_tpu_torch.serve.paged_engine import \
        PagedEngineConfig

    mix = _mix("chat_poisson")
    ec = PagedEngineConfig(**mix["engine"])
    sizes = open_loop.chunk_sizes(mix, ec)
    # prompts 32-768 in chunks of 512, and shared tails after one block
    assert min(sizes) == 1 and max(sizes) == 512
    shapes = open_loop.prefill_shapes(mix, ec)
    assert (16, 64) in shapes and (512, 8) in shapes
    assert (512, 16) not in shapes and (256, 32) not in shapes
    # the most chunks of one bucket an iteration's budget of 2,048 takes:
    # a chunk is taken while budget is left, so ceil(2048 / least)
    for cb, most in {128: 32, 256: 16, 512: 8}.items():
        assert max(rb for b, rb in shapes if b == cb) == most
