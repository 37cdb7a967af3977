"""The port's perplexity harness (bench/perplexity.py) and accuracy report
(bench/accuracy.py) against the JAX package's, on converted weights.

The toy size of tests/test_loader_eval.py in fp32, attention pinned to
"dense" on both sides (the reference's `auto` picks from cache capacity).
Tolerances: perplexities within 1e-5 relative (the order of f32 sums;
the decode path with an INT8 cache within 1e-4, since a K/V value that two
summation orders put on either side of a rounding boundary flips its int8
code); the port's decode path within 2% of its parallel forward, the JAX
test's rule.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu.bench import perplexity as jppl
from physics_llm_inference_tpu.models import config as jcfg_mod
from physics_llm_inference_tpu.models import loader as jld
from physics_llm_inference_tpu.models import quant as jq
from physics_llm_inference_tpu.models import transformer as jtf
from physics_llm_inference_tpu.serve.tokenizer_pool import \
    TokenizerPool as JTokenizerPool
from physics_llm_inference_tpu_torch.bench import accuracy as tacc
from physics_llm_inference_tpu_torch.bench import perplexity as tppl
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models import config as tcfg_mod
from physics_llm_inference_tpu_torch.models import quant as tq
from torch_parity import one_torch_thread, to_numpy  # noqa: F401

SHAPE = dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_dim=48, max_seq_len=64,
             attention_impl="dense")
JCFG = jcfg_mod.ModelConfig(dtype="float32", **SHAPE)
TCFG = tcfg_mod.ModelConfig(dtype="float32", **SHAPE)


@pytest.fixture(scope="module")
def weights():
    jp = jtf.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_jax(to_numpy(jp), device="cpu")


def tokens(seed, n):
    return np.random.default_rng(seed).integers(0, 64, n)


def test_perplexity_matches_reference(weights):
    jp, tp = weights
    toks = tokens(0, 512)
    for batch in (1, 3):
        want = jppl.perplexity(jp, JCFG, toks, window=128, batch=batch)
        got = tppl.perplexity(tp, TCFG, toks, window=128, batch=batch)
        assert got == pytest.approx(want, rel=1e-5)
    assert 64 * 0.5 < got < 64 * 2.0
    with pytest.raises(ValueError, match="shorter than one window"):
        tppl.perplexity(tp, TCFG, toks[:100], window=128)


def test_quantization_report_matches_reference(weights):
    jp, tp = weights
    toks = tokens(1, 512)
    want = jppl.quantization_ppl_report(jp, jq.quantize_params_int8(jp),
                                        JCFG, toks, window=128)
    got = tppl.quantization_ppl_report(tp, tq.quantize_params_int8(tp),
                                       TCFG, toks, window=128)
    assert got.keys() == want.keys()
    for k in ("ppl_fp", "ppl_quantized"):
        assert got[k] == pytest.approx(want[k], rel=1e-5)
    assert got["delta"] == pytest.approx(want["delta"], abs=1e-4)
    assert got["within_budget"] == want["within_budget"]


@pytest.mark.parametrize("mode", ["fp32", "int8_w_kv"])
def test_decode_path_perplexity_matches_reference(weights, mode):
    jp, tp = weights
    toks = tokens(2, 256)
    if mode == "fp32":
        want = jppl.decode_path_perplexity(jp, JCFG, toks, window=128)
        got = tppl.decode_path_perplexity(tp, TCFG, toks, window=128)
        assert got == pytest.approx(want, rel=1e-5)
        par = tppl.perplexity(tp, TCFG, toks, window=128)
        assert abs(got - par) / par < 0.02, (got, par)
    else:
        want = jppl.decode_path_perplexity(jq.quantize_params_int8(jp), JCFG,
                                           toks, window=128,
                                           kv_dtype=jnp.int8)
        got = tppl.decode_path_perplexity(tq.quantize_params_int8(tp), TCFG,
                                          toks, window=128,
                                          kv_dtype=torch.int8)
        assert got == pytest.approx(want, rel=1e-4)


# ------------------------------------------------------- bench/accuracy

SAMPLE = tacc.SAMPLE


def write_checkpoint(path):
    """A toy checkpoint directory as scripts/train_toy.py lays it out: the
    config's fields (attention pinned), JAX-saved f32 params, a held-out
    stream and a small byte-level BPE tokenizer."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, \
        trainers

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(SHAPE, f)
    jld.save_params(os.path.join(path, "params.npz"),
                    jtf.init_params(jax.random.PRNGKey(1), JCFG))
    np.save(os.path.join(path, "heldout.npy"),
            tokens(4, 400).astype(np.int32))
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator([SAMPLE * 4, "return params x"],
                            trainers.BpeTrainer(
                                vocab_size=300, show_progress=False,
                                initial_alphabet=pre_tokenizers.ByteLevel
                                .alphabet()))
    tok.save(os.path.join(path, "tokenizer.json"))


def test_accuracy_report_matches_reference(tmp_path, capsys):
    """bench/accuracy on a toy checkpoint against the JAX functions that
    scripts/accuracy_report.py calls, in its order, on the same files."""
    from tokenizers import Tokenizer, decoders

    ckpt = str(tmp_path / "ckpt")
    write_checkpoint(ckpt)
    out = str(tmp_path / "report.md")
    res = tacc.main(["--ckpt", ckpt, "--device", "cpu", "--window", "128",
                     "--windows", "2", "--out", out])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(res))

    with open(os.path.join(ckpt, "config.json")) as f:
        cfg = jcfg_mod.ModelConfig(dtype="float32", **json.load(f))
    params = jld.load_params(os.path.join(ckpt, "params.npz"))
    held = np.load(os.path.join(ckpt, "heldout.npy"))[:2 * 128]
    rep = jppl.quantization_ppl_report(params, jq.quantize_params_int8(params),
                                       cfg, held, window=128)
    dec_fp = jppl.decode_path_perplexity(params, cfg, held, window=128)
    dec = {"int8": jppl.decode_path_perplexity(
        jq.quantize_params_int8(params), cfg, held, window=128,
        kv_dtype=jnp.int8)}
    for name, mse in (("int4", False), ("int4_mse", True)):
        dec[name] = jppl.decode_path_perplexity(
            jq.quantize_params_int4(params, mse=mse), cfg, held, window=128,
            kv_dtype=jnp.int8)

    assert res["heldout_tokens"] == len(held) == 256
    for k in ("ppl_fp", "ppl_quantized"):
        assert res["forward"][k] == pytest.approx(rep[k], rel=1e-5)
    assert res["decode_fp"] == pytest.approx(dec_fp, rel=1e-5)
    for k, v in dec.items():
        assert res["decode"][k]["ppl"] == pytest.approx(v, rel=1e-4), k
    assert res["budget"] == pytest.approx(max(0.1, 1e-3 * rep["ppl_fp"]),
                                          rel=1e-5)

    def factory():
        t = Tokenizer.from_file(os.path.join(ckpt, "tokenizer.json"))
        t.decoder = decoders.ByteLevel()
        return t

    pool = JTokenizerPool(num_workers=2, tokenizer_factory=factory)
    ids = pool.tokenize(SAMPLE)
    assert res["tokenizer"] == {"ids": len(ids),
                                "exact": pool.detokenize(ids) == SAMPLE}
    assert res["tokenizer"]["exact"]
    text = open(out).read()
    assert "| decode path (INT8 W+KV) |" in text and "exact=True" in text


def test_accuracy_without_tokenizer_or_out(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    write_checkpoint(ckpt)
    os.remove(os.path.join(ckpt, "tokenizer.json"))
    res = tacc.main(["--ckpt", ckpt, "--device", "cpu", "--window", "64",
                     "--windows", "1"])
    assert res["tokenizer"] is None and res["dtype"] == "float32"
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
