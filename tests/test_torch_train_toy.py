"""bench/train_toy (the port of scripts/train_toy.py) against the JAX
package: optax's schedule, the AdamW steps of `jax.value_and_grad` plus
`optax.adamw` on the same params and batches (fp32, TOL["float32"] on the
losses, 1e-5 absolute on the parameters), the loss falling, the checkpoint
read by the JAX package's `load_params`, and JAX's perplexity on it equal
to the port's (fp32 tolerance)."""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from physics_llm_inference_tpu.bench.perplexity import \
    perplexity as jax_perplexity
from physics_llm_inference_tpu.models import ModelConfig as JaxConfig
from physics_llm_inference_tpu.models import init_params as jax_init
from physics_llm_inference_tpu.models.loader import \
    load_params as jax_load_params
from physics_llm_inference_tpu.models.transformer import \
    forward as jax_forward
from physics_llm_inference_tpu_torch.bench import train_toy as tt
from physics_llm_inference_tpu_torch.bench.perplexity import perplexity
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models.config import ModelConfig
from physics_llm_inference_tpu_torch.models.loader import load_params
from torch_parity import TOL, to_numpy

TINY = dict(vocab_size=256, max_seq_len=128, hidden_dim=128, num_layers=2,
            num_heads=2, num_kv_heads=1, intermediate_dim=256)


def _ids(n=20_000, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


def _port_params(jp):
    tree = params_from_jax(to_numpy(jp), device="cpu")

    def own(t):
        return {k: own(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.clone()
    return own(tree)


@pytest.mark.parametrize("warmup,steps", [(50, 600), (2, 5), (0, 10),
                                          (3, 4)])
def test_schedule_is_optax_warmup_cosine(warmup, steps):
    lr = 3e-4
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps)
    got = tt.schedule(warmup, steps)
    for c in range(steps + 3):
        # optax evaluates the schedule in float32: a few ulps of the peak
        assert math.isclose(got(c) * lr, float(want(c)), rel_tol=1e-5,
                            abs_tol=lr * 1e-6), c


def test_adamw_steps_match_jax_value_and_grad_and_optax():
    steps, batch, seq, lr, warmup = 4, 2, 16, 1e-2, 2
    jcfg = JaxConfig(dtype="float32", **TINY)
    cfg = ModelConfig(dtype="float32", **TINY)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    pp = _port_params(jp)
    ids = _ids()

    opt = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, steps), weight_decay=0.01)
    state = opt.init(jp)

    def loss_fn(p, b):
        logits, _ = jax_forward(p, b[:, :-1], jcfg)
        ll = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.take_along_axis(ll, b[:, 1:, None], -1)[..., 0].mean()

    rng = np.random.default_rng(0)
    want_losses = []
    for _ in range(steps):
        starts = rng.integers(0, len(ids) - seq - 1, batch)
        b = jnp.asarray(np.stack([ids[s:s + seq + 1] for s in starts]))
        loss, g = jax.value_and_grad(loss_fn)(jp, b)
        upd, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        want_losses.append(float(loss))

    got = tt.train(pp, cfg, ids, steps, batch=batch, seq=seq, lr=lr,
                   warmup=warmup, log_every=1)
    assert [s for s, _ in got] == list(range(steps))
    np.testing.assert_allclose([v for _, v in got], want_losses,
                               **TOL["float32"])
    want = params_from_jax(to_numpy(jp), device="cpu")
    for name in ("embed", "norm", "lm_head"):
        np.testing.assert_allclose(pp[name].numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)
    for name, t in pp["blocks"].items():
        np.testing.assert_allclose(t.numpy(), want["blocks"][name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_loss_falls_over_30_steps():
    cfg = ModelConfig(dtype="float32", **TINY)
    pp = _port_params(jax_init(jax.random.PRNGKey(0),
                               JaxConfig(dtype="float32", **TINY)))
    # a stream with structure: a repeated 64-token pattern with noise
    rng = np.random.default_rng(1)
    ids = np.tile(rng.integers(0, 256, 64), 300).astype(np.int32)
    noise = rng.random(ids.shape) < 0.05
    ids[noise] = rng.integers(0, 256, int(noise.sum()))
    losses = tt.train(pp, cfg, ids, 30, batch=4, seq=32, lr=3e-3, warmup=3,
                      log_every=5)
    first, last = losses[0][1], losses[-1][1]
    assert last < first - 1.0, losses


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    out = tmp_path_factory.mktemp("toy")
    res = tt.main(["--device", "cpu", "--steps", "4", "--batch", "2",
                   "--seq", "32", "--out", str(out), "--corpus-bytes",
                   str(200_000)], warmup=1, use_bpe=False)
    return out, res


def test_checkpoint_is_read_by_jax_load_params(checkpoint):
    out, res = checkpoint
    jp = jax_load_params(str(out / "params.npz"))
    pp = load_params(str(out / "params.npz"), device="cpu")
    flat_j = jax.tree_util.tree_leaves(jp)
    assert len(flat_j) == 3 + len(pp["blocks"])
    np.testing.assert_array_equal(np.asarray(jp["embed"]),
                                  pp["embed"].numpy())
    for name, t in pp["blocks"].items():
        assert np.asarray(jp["blocks"][name]).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(jp["blocks"][name]),
                                      t.numpy())
    assert res["params"] == sum(int(np.asarray(x).size) for x in flat_j)


def test_jax_perplexity_on_the_checkpoint_equals_the_port(checkpoint):
    out, _ = checkpoint
    conf = json.loads((out / "config.json").read_text())
    conf.pop("tokenizer")
    held = np.load(out / "heldout.npy")[:4 * 64]
    jp = jax_load_params(str(out / "params.npz"))
    want = jax_perplexity(jp, JaxConfig(dtype="float32", **conf), held,
                          window=64)
    pp = load_params(str(out / "params.npz"), device="cpu")
    got = perplexity(pp, ModelConfig(dtype="float32", **conf), held,
                     window=64)
    assert math.isclose(got, want, rel_tol=1e-4), (got, want)


def test_byte_tokenizer_fallback_config(checkpoint):
    out, res = checkpoint
    conf = json.loads((out / "config.json").read_text())
    assert conf == dict(vocab_size=256, max_seq_len=512, tokenizer="bytes",
                        **tt.SHAPES["14m"])
    assert not (out / "tokenizer.json").exists()
    held = np.load(out / "heldout.npy")
    assert held.dtype == np.int32 and held.max() < 256
    assert res["heldout_tokens"] == len(held) == \
        res["tokens"] - int(res["tokens"] * 0.98)
    assert res["tokenizer"] == "bytes" and res["device"] == "cpu"
    assert [s for s, _ in res["losses"]] == [0, 3]


def test_bpe_tokenizer_as_the_script(tmp_path):
    corpus = tt.build_corpus(60_000)
    ids, kind, vocab = tt.tokenize(corpus, 300, str(tmp_path), use_bpe=True)
    assert kind == "bpe" and vocab == 300
    assert (tmp_path / "tokenizer.json").exists()
    assert ids.dtype == np.int32 and 0 <= ids.min() and ids.max() < 300
    assert len(ids) < len(corpus.encode("utf-8"))


def test_split_and_corpus():
    corpus = tt.build_corpus(100_000)
    assert 100_000 <= len(corpus) and "def " in corpus
    train, held = tt.split(np.arange(1_000_000))
    assert len(train) == 980_000 and len(held) == 20_000
    train, held = tt.split(np.arange(20_000_000))
    assert len(held) == tt.HELDOUT_MAX and held[0] == len(train)
