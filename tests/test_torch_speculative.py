"""The port's runtime/speculative.py against the JAX package's, on the cases
of tests/test_speculative.py: the n-gram drafter (host code, exact), and
speculative_generate on the f32 toy model (the port's weights carried from
the JAX ones): tokens, generated lengths and model passes identical to the
JAX function's, and tokens identical to the port's greedy
cached_generate."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.models import ModelConfig as JConfig
from physics_llm_inference_tpu.models import init_params as j_init
from physics_llm_inference_tpu.runtime import speculative as j_spec
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models.config import \
    ModelConfig as TConfig
from physics_llm_inference_tpu_torch.runtime import speculative as t_spec
from physics_llm_inference_tpu_torch.runtime.generate import cached_generate
from torch_parity import to_numpy

# the toy model of tests/test_speculative.py
TOY = dict(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_dim=128, max_seq_len=256,
           dtype="float32")


@pytest.fixture(scope="module")
def toy():
    jparams = j_init(jax.random.PRNGKey(0), JConfig(**TOY))
    return jparams, params_from_jax(to_numpy(jparams), device="cpu")


@pytest.mark.parametrize("hist,k,ngram", [
    ([7, 1, 2, 3, 4, 9, 1, 2], 3, 2),       # continuation of the match
    ([1, 2, 5, 1, 2, 8, 1, 2], 2, 2),       # the most recent match wins
    ([1, 2, 3, 4], 3, 2),                   # no match pads zero
    ([5, 9, 5, 9, 5, 9, 5, 9], 4, 3),
    ([3, 3, 3, 3], 5, 1),
])
def test_ngram_propose_matches_jax(hist, k, ngram):
    h = np.asarray(hist, np.int32)
    got = t_spec.ngram_propose(h, len(h), k=k, ngram=ngram)
    want = j_spec.ngram_propose(h, len(h), k=k, ngram=ngram)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_ngram_index_incremental_matches_jax():
    """The same left-padded history grown token by token: every proposal
    and the index itself equal the original's."""
    rng = np.random.default_rng(5)
    hist = np.zeros(64, np.int32)
    hist[3:12] = [4, 8, 4, 8, 1, 4, 8, 4, 8]
    idx = [mod.NgramIndex(hist, 3, 12, 2) for mod in (t_spec, j_spec)]
    for pos in range(12, 60):
        props = [i.propose(hist, pos, 4) for i in idx]
        np.testing.assert_array_equal(props[0], props[1])
        hist[pos] = props[0][0] if rng.random() < 0.7 else rng.integers(1, 9)
        for i in idx:
            i.add(hist, pos + 1 - 2)
    assert idx[0].idx == idx[1].idx


def _both(toy, prompts, n, **kw):
    jparams, tparams = toy
    jkw = dict(kw)
    if kw.get("kv_dtype") is not None:
        jkw["kv_dtype"] = jnp.int8
        kw["kv_dtype"] = torch.int8
    want = j_spec.speculative_generate(jparams, JConfig(**TOY), prompts, n,
                                       **jkw)
    got = t_spec.speculative_generate(tparams, TConfig(**TOY), prompts, n,
                                      **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.gen_lens, want.gen_lens)
    assert got.extras == want.extras
    return got


@pytest.mark.parametrize("case", ["greedy", "int8-kv", "repetitive"])
def test_speculative_generate_matches_jax(toy, case):
    prompts, n, kw = {
        "greedy": ([[5, 17, 3, 42, 8, 11, 2], [7, 1, 9]], 12, {}),
        "int8-kv": ([[5, 17, 3, 42, 8]], 10, dict(kv_dtype="int8")),
        "repetitive": ([[5, 9, 5, 9, 5, 9, 5, 9]], 40, {}),
    }[case]
    got = _both(toy, prompts, n, draft_k=4, **kw)
    ref = cached_generate(toy[1], TConfig(**TOY), prompts, n,
                          temperature=0.0, kv_dtype=kw.get("kv_dtype"))
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    if case == "repetitive":
        assert got.extras["model_passes"] < 40
        assert got.extras["tokens_per_pass"] > 1.0


def test_speculative_stop_tokens_match_jax(toy):
    prompts = [[5, 17, 3, 42, 8]]
    free = cached_generate(toy[1], TConfig(**TOY), prompts, 10,
                           temperature=0.0)
    toks = list(free.tokens[0])
    pos, stop = next((i, t) for i, t in enumerate(toks)
                     if toks.index(t) == i and i >= 2)
    got = _both(toy, prompts, 10, draft_k=4, stop_tokens=(int(stop),))
    assert int(got.gen_lens[0]) == pos + 1
    np.testing.assert_array_equal(got.tokens[0][:pos + 1], toks[:pos + 1])
