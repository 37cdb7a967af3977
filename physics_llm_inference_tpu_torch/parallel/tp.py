"""Tensor parallelism: the Megatron sharding rule and explicit layers
(counterpart: physics_llm_inference_tpu/parallel/tp.py).

qkv and gate_up are column-sharded (output dim), wo and w_down row-sharded
(input dim, their per-output-channel scales replicated), the embedding
vocab-row-sharded and the lm_head vocab-column-sharded; norms and the MoE
leaves replicate. The JAX package lays a global array out on a mesh; here
each rank holds only its own shard (`tp_prepare_params`) and runs the
unchanged model code on the local config (`tp_local_config`).

How the forward reaches the axis's group: the local config (a
`models/config.TPConfig`) carries the mesh (`cfg.tp_mesh`) beside the axis
name (`cfg.tp_axis`), so the models' `_tp_psum`, `embed_lookup` and
`lm_logits` call `cfg.tp_mesh.all_reduce(y, cfg.tp_axis)` and the like.
Nothing of it is process-wide state: a config without a mesh runs
single-device, whatever another caller built.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.config import ModelConfig, TPConfig, refuse_mla
from ..models.quant import QuantizedTensor, QuantizedTensor4

REPLICATED = None


def _spec(name: str, is_scale: bool):
    """The split dim of one leaf (negative, from the end), or REPLICATED."""
    if name == "embed":
        return 0
    if name in ("lm_head", "wqkv", "w_gate_up"):
        return -1                      # columns (scales shard with them)
    if name in ("wo", "w_down"):
        return REPLICATED if is_scale else -2   # rows; per-out scales
    return REPLICATED


def tp_param_spec_tree(params: dict) -> dict:
    """A tree of the params' shape whose leaves are each leaf's split dim
    (an int counted from the end, or 0 for the embedding's rows) or
    REPLICATED (None); a quantized leaf's spec is a pair (q's, s's)."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (QuantizedTensor, QuantizedTensor4)):
            return type(tree)(_spec(name, False), _spec(name, True))
        return _spec(name, False)

    return walk(params)


def _fused_column_perm(widths: list[int], tp: int) -> np.ndarray:
    """new -> old column index for a fused projection [seg0 | seg1 | ...],
    so that a contiguous 1/tp column shard holds [seg0_i | seg1_i | ...]:
    without it shard 0 of wqkv would hold only q columns."""
    offs = np.cumsum([0] + list(widths[:-1]))
    idx = []
    for i in range(tp):
        for w, off in zip(widths, offs):
            per = w // tp
            idx.extend(range(off + i * per, off + (i + 1) * per))
    return np.asarray(idx, dtype=np.int64)


def _permute_cols(w, idx):
    """`w` with its last dim taken in the order `idx`."""
    if isinstance(w, QuantizedTensor):
        i = torch.as_tensor(idx, device=w.q.device)
        return QuantizedTensor(w.q.index_select(-1, i),
                               w.s.index_select(-1, i))
    return w.index_select(-1, torch.as_tensor(idx, device=w.device))


def _shard(t: torch.Tensor, dim, tp: int, i: int, device) -> torch.Tensor:
    if dim is REPLICATED or tp == 1:
        return t.to(device).contiguous()
    per = t.shape[dim] // tp
    return t.narrow(dim, i * per, per).to(device).contiguous()


def tp_param_specs():
    """The sharding rule as a function of a leaf's key path (e.g.
    ("blocks", "wqkv")) and the leaf: its split dim or REPLICATED, the q
    values' for a quantized leaf."""
    def spec(path, x):
        return _spec(path[-1], False)

    return spec


def _shard_tree(params: dict, mesh, axis: str, perms: dict) -> dict:
    tp, i = mesh.size(axis), mesh.index(axis)
    specs = tp_param_spec_tree(params)
    dev = mesh.device

    def leaf(w, spec, perm=None):
        if perm is not None and tp > 1:
            # the shard's slice of the permutation: its columns alone
            per = len(perm) // tp
            w = _permute_cols(w, perm[i * per:(i + 1) * per])
            spec = (REPLICATED, REPLICATED) if isinstance(
                w, QuantizedTensor) else REPLICATED
        if isinstance(w, QuantizedTensor):
            return QuantizedTensor(_shard(w.q, spec[0], tp, i, dev),
                                   _shard(w.s, spec[1], tp, i, dev))
        return _shard(w, spec, tp, i, dev)

    out = {k: leaf(v, specs[k]) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: leaf(w, specs["blocks"][k], perms.get(k))
                     for k, w in params["blocks"].items()}
    return out


def tp_shard_params(params: dict, mesh, axis: str = "model") -> dict:
    """This rank's shard of every leaf by tp_param_spec_tree, as contiguous
    tensors on the mesh's device (no column permutation)."""
    return _shard_tree(params, mesh, axis, {})


def tp_prepare_params(params: dict, cfg, mesh, axis: str = "model") -> dict:
    """This rank's shard of the full params, the one-stop preparation of a
    TP engine: the fused projections permuted for shard locality, then
    each leaf cut by tp_param_spec_tree, as contiguous tensors on the
    mesh's device. Of a permuted projection only the shard's columns are
    ever gathered."""
    if any(isinstance(w, QuantizedTensor4)
           for w in params["blocks"].values()):
        raise ValueError("INT4 (nibble-packed) weights are not TP-shardable: "
                         "splitting the packed last dim interleaves lo/hi "
                         "channel pairs. Use INT8 for TP.")
    tp, hd = mesh.size(axis), cfg.head_dim
    perms = {
        "wqkv": _fused_column_perm([cfg.num_heads * hd, cfg.num_kv_heads * hd,
                                    cfg.num_kv_heads * hd], tp),
        "w_gate_up": _fused_column_perm([cfg.intermediate_dim,
                                         cfg.intermediate_dim], tp),
    }
    return _shard_tree(params, mesh, axis, perms)


def tp_kv_spec(quantized: bool, data: str | None = "data",
               model: str | None = "model", paged_merged: bool = False):
    """Which dim of each KV pool an axis shards, as {axis: dim}: requests
    (the slot axis, dim 1) over `data`, KV heads over `model`. Slot pools:
    plain (L, B, S, Hkv, hd); QuantKV values (L, B, S, Hkv·hd) head-major
    (a model shard of the last dim is a contiguous group of KV heads) and
    scales (L, B, Hkv, S). Merged paged pools: values (L, NB, 2, BS,
    Hkv·hd), scales (L, NB, 2, Hkv, BS), blocks on dim 1 (the paged engine
    passes data=None: it shards on `model` alone)."""
    from ..models.transformer import QuantKV

    def spec(d_dim, m_dim):
        out = {}
        if data is not None:
            out[data] = d_dim
        if model is not None:
            out[model] = m_dim
        return out

    if quantized and paged_merged:
        return QuantKV(q=spec(1, 4), s=spec(1, 3))
    if quantized:
        return QuantKV(q=spec(1, 3), s=spec(1, 2))
    return spec(1, 3)


def tp_local_config(cfg, tp: int, axis: str = "model",
                    data_axis: str | None = "data", mesh=None):
    """The per-rank config, a TPConfig: heads and FFN width divided by the
    TP degree, head_dim kept (head_dim_override), `tp_axis` and the mesh
    set so the forward all-reduces row-parallel partial sums and
    all-gathers the vocab-sharded logits. vocab_size stays global."""
    refuse_mla(cfg, "tensor parallelism (parallel/tp.py)")
    if cfg.num_kv_heads % tp:
        raise ValueError(f"num_kv_heads {cfg.num_kv_heads} must divide TP "
                         f"degree {tp}")
    if cfg.intermediate_dim % tp or cfg.vocab_size % tp:
        raise ValueError(f"intermediate_dim {cfg.intermediate_dim} and "
                         f"vocab_size {cfg.vocab_size} must divide TP "
                         f"degree {tp}")
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    fields.update(
        num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_dim=cfg.intermediate_dim // tp,
        head_dim_override=cfg.head_dim,
        tp_axis=axis,
        tp_data_axis=data_axis,
    )
    return TPConfig(**fields, tp_mesh=mesh)


def column_parallel_linear(x: torch.Tensor, w_shard: torch.Tensor
                           ) -> torch.Tensor:
    """The matmul with the weight split on its output dim: the output stays
    sharded, no collective (the next row-parallel layer reduces)."""
    return x @ w_shard


def row_parallel_linear(x_shard: torch.Tensor, w_shard: torch.Tensor,
                        mesh, axis: str = "model") -> torch.Tensor:
    """The partial product of an input-dim shard, all-reduced over
    `axis`."""
    return mesh.all_reduce(x_shard @ w_shard, axis)


def tp_mlp(mesh, x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """Tensor-parallel SwiGLU MLP over `axis` (tp_mlp_shardmap's
    counterpart): x (..., D) replicated and the FULL weights w_gate/w_up
    (D, F), w_down (F, D); this rank takes its column shard of gate and up
    and its row shard of down, and all-reduces the partial sum."""
    tp, i = mesh.size(axis), mesh.index(axis)
    per = w_gate.shape[1] // tp
    cols = slice(i * per, (i + 1) * per)
    gate = column_parallel_linear(x, w_gate[:, cols])
    up = column_parallel_linear(x, w_up[:, cols])
    hidden = torch.nn.functional.silu(gate) * up
    return row_parallel_linear(hidden, w_down[cols], mesh, axis)


# the JAX package's name for the explicit TP MLP
tp_mlp_shardmap = tp_mlp


def compute_tp_memory_savings(num_params: int, world_size: int,
                              dtype_bytes: int = 2) -> dict:
    """Params and bytes per device against the world size."""
    per_device = num_params / world_size
    return {
        "total_params": num_params,
        "params_per_device": per_device,
        "bytes_per_device": per_device * dtype_bytes,
        "reduction_factor": world_size,
    }
