"""Weight loading: HF-Llama-style checkpoints -> stacked params; native
save/load (counterpart: physics_llm_inference_tpu/models/loader.py).

`params_from_hf_state_dict` maps a Llama-family state dict (HF naming) onto
the stacked layout of models/transformer.py; `load_llama` reads a directory
of safetensors shards into it, optionally quantizing to INT8 on the way in.
`save_params`/`load_params` write and read the JAX package's npz format:
flat dotted keys, a `__namedtuple__` tag beside each NamedTuple's fields.

What differs from the JAX package, on purpose:
- The safetensors format is read here (`read_safetensors`), not by the
  `safetensors` package: an 8-byte little-endian header length, a JSON
  header of {name: {dtype, shape, data_offsets}}, then the raw bytes, each
  tensor a `torch.frombuffer` view of a copy-on-write `mmap` of its file.
- Each tensor stays in the checkpoint's dtype on the host. It is moved to
  the target device as it is, and transposed, stacked and cast to the
  model dtype there, one tensor at a time, where the JAX package first
  upcasts every tensor to f32 on the host (4 bytes a parameter: 26.95 GB
  for LLAMA_7B_CONFIG's 6.738 B).
- Every tensor's shape is checked against the config, with its key in the
  error, where the JAX package asserts two shapes.

What is kept from the JAX package, faults included (a fix belongs to both):
- `load_params` rebuilds only `QuantizedTensor` leaves. A saved
  `QuantizedTensor4` comes back as a plain {"q", "s"} dict.
- A bf16 leaf is written as the bytes of ml_dtypes' bfloat16, npy descr
  '<V2', which the JAX package's `load_params` refuses (a void dtype is no
  JAX array type); `load_params` here refuses it too, naming the leaf.
- `load_params`'s `dtype` argument is accepted and changes nothing.
Entry points put their tensors on the card (`device=None` means "cuda")
unless the caller names another device.
"""
from __future__ import annotations

import json
import mmap
import os
import zipfile

import numpy as np
import torch

from .config import ModelConfig, torch_dtype
from .quant import QuantizedTensor

# safetensors dtype names -> torch dtypes; any other raises
SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
                      "F32": torch.float32, "I8": torch.int8,
                      "I32": torch.int32}


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _target_dtype(dtype, cfg: ModelConfig) -> torch.dtype:
    """None -> the config's dtype; a torch dtype, a name ("bfloat16") or a
    numpy dtype (np.float32) -> that dtype."""
    if dtype is None:
        return torch_dtype(cfg)
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        return getattr(torch, dtype)
    return getattr(torch, np.dtype(dtype).name)


def _as_tensor(t) -> torch.Tensor:
    """A torch tensor or numpy array, in its own dtype (a read-only array
    copied, since torch takes only writable memory)."""
    if isinstance(t, torch.Tensor):
        return t.detach()
    a = np.asarray(t)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def params_from_hf_state_dict(state: dict, cfg: ModelConfig, dtype=None,
                              device=None) -> dict:
    """Map HF Llama naming to the stacked layout.

    Expected keys (per layer i):
      model.embed_tokens.weight                        (V, D)
      model.layers.{i}.input_layernorm.weight          (D,)
      model.layers.{i}.self_attn.{q,k,v,o}_proj.weight (out, in)
      model.layers.{i}.post_attention_layernorm.weight (D,)
      model.layers.{i}.mlp.{gate,up,down}_proj.weight
      model.norm.weight, lm_head.weight                (V, D)

    HF Linear stores (out, in); our convention is x @ w with w (in, out), so
    every projection transposes. Values are torch tensors or numpy arrays;
    each goes to `device` in its own dtype, where it is transposed into its
    stack and cast to `dtype` (default: cfg.dtype). A missing key raises
    KeyError, a tensor of the wrong shape ValueError."""
    dtype = _target_dtype(dtype, cfg)
    dev = _device(device)
    L, d, f = cfg.num_layers, cfg.hidden_dim, cfg.intermediate_dim
    hd, v = cfg.head_dim, cfg.vocab_size
    hq, hkv = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def get(name, shape):
        if name not in state:
            raise KeyError(f"checkpoint missing {name}")
        t = _as_tensor(state[name])
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the config "
                             f"needs {shape}")
        return t.to(dev)

    def stacked(parts, transpose=True):
        """[(HF name format, HF shape)] of one stacked leaf, concatenated on
        the last axis after the transpose: (L, in, sum of outs)."""
        outs = [shape[0] for _, shape in parts]
        width = sum(outs) if transpose else parts[0][1][0]
        inner = (parts[0][1][1], width) if transpose else (width,)
        out = torch.empty((L, *inner), dtype=dtype, device=dev)
        for i in range(L):
            col = 0
            for fmt, shape in parts:
                w = get(fmt.format(i=i), shape)
                if transpose:
                    out[i, :, col:col + shape[0]].copy_(w.t())
                    col += shape[0]
                else:
                    out[i].copy_(w)
                del w
        return out

    attn = "model.layers.{i}.self_attn."
    mlp = "model.layers.{i}.mlp."
    blocks = {
        "ln1": stacked([("model.layers.{i}.input_layernorm.weight", (d,))],
                       transpose=False),
        "wqkv": stacked([(attn + "q_proj.weight", (hq, d)),
                         (attn + "k_proj.weight", (hkv, d)),
                         (attn + "v_proj.weight", (hkv, d))]),
        "wo": stacked([(attn + "o_proj.weight", (d, hq))]),
        "ln2": stacked([("model.layers.{i}.post_attention_layernorm.weight",
                         (d,))], transpose=False),
        "w_gate_up": stacked([(mlp + "gate_proj.weight", (f, d)),
                              (mlp + "up_proj.weight", (f, d))]),
        "w_down": stacked([(mlp + "down_proj.weight", (d, f))]),
    }

    def single(name, shape, transpose=False):
        w = get(name, shape)
        w = w.t() if transpose else w
        return torch.empty(w.shape, dtype=dtype, device=dev).copy_(w)

    return {"embed": single("model.embed_tokens.weight", (v, d)),
            "blocks": blocks,
            "norm": single("model.norm.weight", (d,)),
            "lm_head": single("lm_head.weight", (v, d), transpose=True)}


def read_safetensors(path: str) -> dict:
    """One safetensors file -> {name: CPU tensor in its stored dtype}, each a
    view of a copy-on-write mmap of the file (nothing is read until used)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        n = int.from_bytes(head, "little")
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt = SAFETENSORS_DTYPES.get(meta["dtype"])
        if dt is None:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}; "
                             f"the reader takes {sorted(SAFETENSORS_DTYPES)}")
        begin, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dt).element_size()
        if end - begin != count * itemsize or base + end > size:
            raise ValueError(f"{path}: {name} has data_offsets {begin, end} "
                             f"for shape {shape} {meta['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dt)
            continue
        out[name] = torch.frombuffer(mm, dtype=dt, count=count,
                                     offset=base + begin).reshape(shape)
    return out


def load_safetensors_dir(path: str) -> dict:
    """Read all *.safetensors shards in a directory into one state dict."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    state = {}
    for f in files:
        state.update(read_safetensors(os.path.join(path, f)))
    return state


def load_llama(path: str, cfg: ModelConfig, dtype=None, int8: bool = False,
               device=None) -> dict:
    """Directory of safetensors -> params on `device` (optionally
    INT8-quantized)."""
    params = params_from_hf_state_dict(load_safetensors_dir(path), cfg,
                                       dtype, device)
    if int8:
        from .quant import quantize_params_int8

        params = quantize_params_int8(params)
    return params


# --- native checkpoint save/resume (npz; flat dotted keys) -------------------

def _npy_leaf(t) -> tuple[np.ndarray, str | None]:
    """A leaf as (numpy array, npy descr override): a bf16 tensor as its raw
    2-byte words under ml_dtypes' descr '<V2', as the JAX package writes a
    bfloat16 array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2"), "<V2"
        return t.numpy(), None
    return np.asarray(t), None


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif hasattr(tree, "_fields"):  # NamedTuple (QuantizedTensor, QuantKV)
        out[f"{prefix}__namedtuple__"] = (np.array(type(tree).__name__), None)
        for k, v in zip(tree._fields, tree):
            out.update(_flatten(v, f"{prefix}{k}."))
    else:
        out[prefix[:-1]] = _npy_leaf(tree)
    return out


def save_params(path: str, params: dict) -> None:
    """np.savez's archive of the flattened tree: one stored (uncompressed)
    `<key>.npy` member each, in the order np.savez writes them; ".npz" is
    appended to a path without it, as np.savez does."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    fmt = np.lib.format
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, descr) in _flatten(params).items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if descr is None:
                    fmt.write_array(fid, arr, allow_pickle=False)
                else:
                    fmt.write_array_header_1_0(fid, {
                        "descr": descr, "fortran_order": False,
                        "shape": arr.shape})
                    fid.write(arr.tobytes())


def load_params(path: str, dtype=None, device=None) -> dict:
    """Rebuild the nested params dict (incl. QuantizedTensor leaves) on
    `device`. `dtype` changes nothing, as in the JAX package. A leaf of a
    void dtype (a bf16 leaf written through ml_dtypes) raises TypeError."""
    del dtype  # the JAX package's load_params ignores it too
    dev = _device(device)
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as npz:
        flat = {k: npz[k] for k in npz.files}
    root: dict = {}
    ntuples: dict = {}
    for key, val in flat.items():
        parts = key.split(".")
        if parts[-1] == "__namedtuple__":
            ntuples[".".join(parts[:-1])] = str(val)
            continue
        if val.dtype.kind == "V":
            raise TypeError(f"{key}: dtype {val.dtype.str} is a raw "
                            f"{val.dtype.itemsize}-byte word (a bfloat16 leaf "
                            "written through ml_dtypes), which load_params "
                            "cannot type")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(val).to(dev)

    def rebuild(node, prefix=""):
        if not isinstance(node, dict):
            return node
        out = {k: rebuild(v, f"{prefix}{k}.") for k, v in node.items()}
        if ntuples.get(prefix[:-1]) == "QuantizedTensor":
            return QuantizedTensor(q=out["q"], s=out["s"])
        return out

    return rebuild(root)
