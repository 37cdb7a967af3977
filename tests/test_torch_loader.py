"""The port's checkpoint loader (models/loader.py) and the CLI's --ckpt/--hf
against the JAX package's, on the same state dicts and files.

Tolerances: leaves mapped from one state dict are bit-equal (a transpose
and a cast are exact or round the same way in both); fp32 forward logits
within 1e-5 (the order of f32 sums); files load to bit-equal leaves; the
CLI's text is equal.
"""
import dataclasses
import io
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_llm_inference_tpu import cli as jcli
from physics_llm_inference_tpu.models import config as jcfg_mod
from physics_llm_inference_tpu.models import loader as jld
from physics_llm_inference_tpu.models import quant as jq
from physics_llm_inference_tpu.models import transformer as jtf
from physics_llm_inference_tpu_torch import cli as tcli
from physics_llm_inference_tpu_torch.convert import params_from_jax
from physics_llm_inference_tpu_torch.models import config as tcfg_mod
from physics_llm_inference_tpu_torch.models import loader as tld
from physics_llm_inference_tpu_torch.models import quant as tq
from physics_llm_inference_tpu_torch.models import transformer as ttf
from torch_parity import one_torch_thread, t2n, to_numpy  # noqa: F401

# the toy size of tests/test_loader_eval.py, attention pinned on both sides
SHAPE = dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_dim=48, max_seq_len=64,
             attention_impl="dense")
JCFG = jcfg_mod.ModelConfig(dtype="float32", **SHAPE)
TCFG = tcfg_mod.ModelConfig(dtype="float32", **SHAPE)


def hf_state(cfg, seed=0, kind="numpy"):
    """A seeded HF-named state dict: numpy f64 (as tests/test_loader_eval.py
    makes it), or torch tensors in f32 or bf16."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.hidden_dim, cfg.head_dim
    f, v, L = cfg.intermediate_dim, cfg.vocab_size, cfg.num_layers
    state = {"model.embed_tokens.weight": rng.normal(0, .02, (v, d)),
             "model.norm.weight": 1 + rng.normal(0, .1, d),
             "lm_head.weight": rng.normal(0, .02, (v, d))}
    for i in range(L):
        p = f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = 1 + rng.normal(0, .1, d)
        state[p + "post_attention_layernorm.weight"] = 1 + rng.normal(0, .1, d)
        for name, shape in (("q", (cfg.num_heads * hd, d)),
                            ("k", (cfg.num_kv_heads * hd, d)),
                            ("v", (cfg.num_kv_heads * hd, d)),
                            ("o", (d, cfg.num_heads * hd))):
            state[p + f"self_attn.{name}_proj.weight"] = rng.normal(0, .02,
                                                                  shape)
        state[p + "mlp.gate_proj.weight"] = rng.normal(0, .02, (f, d))
        state[p + "mlp.up_proj.weight"] = rng.normal(0, .02, (f, d))
        state[p + "mlp.down_proj.weight"] = rng.normal(0, .02, (d, f))
    if kind == "numpy":
        return state
    dt = {"torch_f32": torch.float32, "torch_bf16": torch.bfloat16}[kind]
    return {k: torch.from_numpy(a).to(dt) for k, a in state.items()}


def leaves(tree, prefix=""):
    """{dotted key: numpy f32/int array} of a JAX or port params tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}."))
    elif hasattr(tree, "_fields"):
        out[prefix + "__type__"] = type(tree).__name__
        for k, v in zip(tree._fields, tree):
            out.update(leaves(v, f"{prefix}{k}."))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = t2n(tree)
    else:  # numpy, or ml_dtypes bfloat16 (kind "V")
        a = np.asarray(tree)
        out[prefix[:-1]] = a if a.dtype.kind in "iub" else a.astype(np.float32)
    return out


def assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        if k.endswith("__type__"):
            assert la[k] == lb[k], k
        else:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def logits_pair(jparams, tparams, jcfg=JCFG, tcfg=TCFG):
    ids = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 9))
    jl, _ = jtf.forward(jparams, jnp.asarray(ids, jnp.int32), jcfg)
    tl, _ = ttf.forward(tparams, torch.from_numpy(ids), tcfg)
    return np.asarray(jl), t2n(tl)


# ------------------------------------------------------------ the HF map

@pytest.mark.parametrize("kind", ["numpy", "torch_f32", "torch_bf16"])
def test_hf_map_leaves_and_logits_match_reference(kind):
    state = hf_state(JCFG, kind=kind)
    jp = jld.params_from_hf_state_dict(state, JCFG, dtype=np.float32)
    tp = tld.params_from_hf_state_dict(state, TCFG, dtype=np.float32,
                                       device="cpu")
    assert_trees_equal(to_numpy(jp), tp)
    jl, tl = logits_pair(jp, tp)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)


def test_hf_map_to_bf16_rounds_as_reference():
    """The cast to the config's dtype (bf16) on the target device rounds
    every value as the JAX package's host cast does."""
    jcfg = dataclasses.replace(JCFG, dtype="bfloat16")
    tcfg = dataclasses.replace(TCFG, dtype="bfloat16")
    for kind in ("numpy", "torch_f32"):
        state = hf_state(jcfg, seed=3, kind=kind)
        jp = jld.params_from_hf_state_dict(state, jcfg)
        tp = tld.params_from_hf_state_dict(state, tcfg, device="cpu")
        assert tp["blocks"]["wqkv"].dtype == torch.bfloat16
        assert_trees_equal(to_numpy(jp), tp)


def test_hf_map_missing_key_raises_keyerror_in_both():
    for name in ("model.norm.weight", "model.layers.1.mlp.up_proj.weight"):
        state = hf_state(JCFG)
        del state[name]
        with pytest.raises(KeyError, match="missing"):
            jld.params_from_hf_state_dict(state, JCFG)
        with pytest.raises(KeyError, match="missing"):
            tld.params_from_hf_state_dict(state, TCFG, device="cpu")


def test_hf_map_wrong_shape_names_the_key():
    state = hf_state(JCFG)
    state["model.layers.0.self_attn.o_proj.weight"] = np.zeros((32, 31))
    with pytest.raises(ValueError, match="layers.0.self_attn.o_proj"):
        tld.params_from_hf_state_dict(state, TCFG, device="cpu")


# ---------------------------------------------------- the safetensors reader

def write_shards(tmp_path, state, split=2):
    """`state` (torch tensors) as `split` safetensors shards, written by the
    safetensors package (present in this sandbox, not on the card's
    machine, which is why the port reads the format itself)."""
    st = pytest.importorskip("safetensors.torch")
    names = sorted(state)
    for i in range(split):
        part = {k: state[k].contiguous() for k in names[i::split]}
        st.save_file(part, str(tmp_path / f"model-{i:05d}.safetensors"))
    return str(tmp_path)


def test_safetensors_reader_matches_writer(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"a.bf16": torch.randn((7, 5), generator=g).bfloat16(),
             "b.f16": torch.randn((3,), generator=g).half(),
             "c.f32": torch.randn((2, 3, 4), generator=g),
             "d.i8": torch.randint(-128, 128, (9,), generator=g,
                                   dtype=torch.int8),
             "e.i32": torch.randint(-9, 9, (2, 2), generator=g,
                                    dtype=torch.int32),
             "f.empty": torch.zeros((0, 4)),
             "g.odd_bf16": torch.randn((3,), generator=g).bfloat16()}
    got = tld.load_safetensors_dir(write_shards(tmp_path, state))
    assert got.keys() == state.keys()
    for k, t in state.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    write_shards(tmp_path, {"x": torch.zeros(3, dtype=torch.float64),
                            "y": torch.zeros(2)})
    with pytest.raises(ValueError, match="x has dtype F64"):
        tld.load_safetensors_dir(str(tmp_path))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tld.load_safetensors_dir(str(empty))


def test_load_llama_matches_reference(tmp_path):
    """f32 shards: the JAX load_llama (safetensors, numpy) and the port's
    reader give the same params, INT8 included; bf16 shards load to the
    f32 tree's bf16 rounding."""
    state = hf_state(JCFG, seed=1, kind="torch_f32")
    path = write_shards(tmp_path, state)
    for int8 in (False, True):
        jp = jld.load_llama(path, JCFG, int8=int8)
        tp = tld.load_llama(path, TCFG, int8=int8, device="cpu")
        assert_trees_equal(to_numpy(jp), tp)
    bf = tmp_path / "bf16"
    bf.mkdir()
    path16 = write_shards(bf, {k: t.bfloat16() for k, t in state.items()})
    tp16 = tld.load_llama(path16, TCFG, device="cpu")
    want = tld.params_from_hf_state_dict(
        {k: t.bfloat16() for k, t in state.items()}, TCFG, device="cpu")
    assert_trees_equal(want, tp16)


# ------------------------------------------------------- the npz format

def members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def jax_int8_tree():
    return jq.quantize_params_int8(jtf.init_params(jax.random.PRNGKey(0),
                                                   JCFG))


@pytest.mark.parametrize("tree", ["dense", "int8"])
def test_npz_jax_save_port_load(tmp_path, tree):
    jp = (jtf.init_params(jax.random.PRNGKey(0), JCFG) if tree == "dense"
          else jax_int8_tree())
    path = str(tmp_path / "j.npz")
    jld.save_params(path, jp)
    tp = tld.load_params(path, device="cpu")
    if tree == "int8":
        assert isinstance(tp["blocks"]["wqkv"], tq.QuantizedTensor)
        assert isinstance(tp["lm_head"], tq.QuantizedTensor)
    assert_trees_equal(to_numpy(jld.load_params(path)), tp)
    jl, tl = logits_pair(jp, tp)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tree", ["dense", "int8"])
def test_npz_port_save_jax_load_byte_for_byte(tmp_path, tree):
    """The port's file loads in the JAX package, and every npy member is
    byte-equal to the one the JAX package writes for the same tree (the
    zip's timestamps differ)."""
    jp = (jtf.init_params(jax.random.PRNGKey(0), JCFG) if tree == "dense"
          else jax_int8_tree())
    tp = params_from_jax(to_numpy(jp), device="cpu")
    tpath, jpath = str(tmp_path / "t"), str(tmp_path / "j.npz")
    tld.save_params(tpath, tp)            # ".npz" appended, as np.savez does
    jld.save_params(jpath, jp)
    assert members(tpath + ".npz") == members(jpath)
    back = jld.load_params(tpath)
    assert_trees_equal(to_numpy(back), tp)
    if tree == "int8":
        assert isinstance(back["blocks"]["wo"], jq.QuantizedTensor)


def test_npz_bf16_tree_refused_on_both_sides(tmp_path):
    """A bf16 leaf is stored as npy descr '<V2' by both packages, and both
    load_params refuse it (the reference's hazard, kept)."""
    jp = jtf.init_params(jax.random.PRNGKey(0),
                         dataclasses.replace(JCFG, dtype="bfloat16"))
    tp = params_from_jax(to_numpy(jp), device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tld.save_params(tpath, tp)
    jld.save_params(jpath, jp)
    assert members(tpath) == members(jpath)
    head = io.BytesIO(members(tpath)["embed.npy"]).read(80)
    assert b"'descr': '<V2'" in head
    for path in (tpath, jpath):
        with pytest.raises(TypeError, match="V2"):
            jld.load_params(path)
        with pytest.raises(TypeError, match="embed"):
            tld.load_params(path, device="cpu")


def test_npz_int4_tree_comes_back_as_dicts_on_both_sides(tmp_path):
    """QuantizedTensor4 leaves come back as plain {q, s} dicts from both
    load_params (only QuantizedTensor is rebuilt: the reference's hazard,
    kept); the lm_head stays a QuantizedTensor."""
    jp = jq.quantize_params_int4(jtf.init_params(jax.random.PRNGKey(0),
                                                 JCFG))
    tp = params_from_jax(to_numpy(jp), device="cpu")
    assert isinstance(tp["blocks"]["wqkv"], tq.QuantizedTensor4)
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tld.save_params(tpath, tp)
    jld.save_params(jpath, jp)
    assert members(tpath) == members(jpath)
    for path in (tpath, jpath):
        jb = jld.load_params(path)
        tb = tld.load_params(path, device="cpu")
        for b in (jb, tb):
            assert type(b["blocks"]["wqkv"]) is dict
            assert set(b["blocks"]["wqkv"]) == {"q", "s"}
            assert type(b["lm_head"]).__name__ == "QuantizedTensor"
        assert_trees_equal(to_numpy(jb), tb)
        np.testing.assert_array_equal(t2n(tb["blocks"]["w_down"]["q"]),
                                      np.asarray(jp["blocks"]["w_down"].q))


def test_load_params_dtype_changes_nothing(tmp_path):
    path = str(tmp_path / "j.npz")
    jld.save_params(path, jtf.init_params(jax.random.PRNGKey(0), JCFG))
    a = tld.load_params(path, device="cpu")
    b = tld.load_params(path, dtype=torch.bfloat16, device="cpu")
    assert b["embed"].dtype == torch.float32
    assert_trees_equal(a, b)


# ------------------------------------------------------------- the CLI

def toy_files(tmp_path):
    """The CLI's `toy` preset (f32) as a JAX npz checkpoint and as f32 HF
    safetensors shards of the same weights."""
    cfg = jcli._named_config("toy")
    jp = jtf.init_params(jax.random.PRNGKey(3), cfg)
    ckpt = str(tmp_path / "toy.npz")
    jld.save_params(ckpt, jp)
    b = {k: np.asarray(v) for k, v in jp["blocks"].items()}
    hd, hq = cfg.head_dim, cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * hd
    f = cfg.intermediate_dim
    state = {"model.embed_tokens.weight": np.asarray(jp["embed"]),
             "model.norm.weight": np.asarray(jp["norm"]),
             "lm_head.weight": np.asarray(jp["lm_head"]).T}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        wqkv = b["wqkv"][i]
        state.update({
            p + "input_layernorm.weight": b["ln1"][i],
            p + "post_attention_layernorm.weight": b["ln2"][i],
            p + "self_attn.q_proj.weight": wqkv[:, :hq].T,
            p + "self_attn.k_proj.weight": wqkv[:, hq:hq + hkv].T,
            p + "self_attn.v_proj.weight": wqkv[:, hq + hkv:].T,
            p + "self_attn.o_proj.weight": b["wo"][i].T,
            p + "mlp.gate_proj.weight": b["w_gate_up"][i][:, :f].T,
            p + "mlp.up_proj.weight": b["w_gate_up"][i][:, f:].T,
            p + "mlp.down_proj.weight": b["w_down"][i].T})
    hf = tmp_path / "hf"
    hf.mkdir()
    write_shards(hf, {k: torch.from_numpy(np.array(v))
                      for k, v in state.items()})
    return ckpt, str(hf)


@pytest.mark.parametrize("src", ["ckpt", "hf", "hf_int8"])
def test_cli_generate_from_files_matches_reference(tmp_path, capsys, src):
    ckpt, hf = toy_files(tmp_path)
    flags = {"ckpt": ["--ckpt", ckpt], "hf": ["--hf", hf],
             "hf_int8": ["--hf", hf, "--int8"]}[src]
    argv = ["generate", "--config", "toy", "--prompt", "load me",
            "--max-tokens", "8"] + flags
    jcli.main(argv)
    want = capsys.readouterr().out
    tcli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert len(want.rstrip("\n")) == 8
    assert got == want
