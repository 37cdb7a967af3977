"""Expert-parallel scaling (counterpart: scripts/ep_scaling.py): the EP
dispatch run against the single-device layer, then the cost model's
prediction by EP degree for the serving-scale MoE of BASELINE config 5.

    python -m torch.distributed.run --nproc-per-node N \\
        -m physics_llm_inference_tpu_torch.bench.ep_scaling [--device cpu]

Without a launched world it runs as a world of one rank. Executed:
`parallel/ep.moe_layer_ep` over the world's `expert` axis (capacity grids
exchanged by all-to-all), held to the single-device `models/moe.moe_layer`
at a no-drop capacity. Predicted: a decode step at EP 1-8 over NVLink,
weak scaling (every GPU keeps a full batch of its own requests, experts
shard E ways): the expert weight stream each GPU reads shrinks 1/EP, the
KV and dense weights stay, and each MoE layer pays two all-to-alls of the
local capacity grid. Data-sheet arithmetic (specs/nvlink.py, specs/gpu.py),
not a measurement. Rank 0 prints one JSON object.
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from ..models.config import ModelConfig, MoEConfig
from ..models.moe import init_moe_params, moe_layer
from ..parallel import initialize_multihost, make_mesh, moe_layer_ep
from ..specs.gpu import H100_SXM
from ..specs.nvlink import CollectiveCostModel


def executed(mesh, axis: str = "expert", tokens: int = 64, d: int = 256,
             f: int = 512, seed: int = 0) -> dict:
    """moe_layer_ep over `axis` against moe_layer over all tokens, at
    capacity factor 8.0 (no token dropped, so the two agree: EP computes
    capacity from its local token count)."""
    dev = mesh.device
    n = mesh.size(axis)
    moe = MoEConfig(num_experts=8, num_experts_per_tok=2,
                    capacity_factor=8.0)
    cfg = ModelConfig(vocab_size=64, hidden_dim=d, num_layers=1, num_heads=2,
                      num_kv_heads=2, intermediate_dim=f, dtype="float32")
    g = torch.Generator(device=dev).manual_seed(seed)
    params = init_moe_params(g, cfg, moe)
    x = torch.randn((tokens, d), generator=g, device=dev)
    ref, _ = moe_layer(x, params, moe)
    out = moe_layer_ep(mesh, x, params, moe, axis=axis)
    err = float((out - ref).abs().max())
    rel = err / (float(ref.abs().max()) + 1e-9)
    return {"ranks": n, "device": str(dev), "tokens": tokens,
            "experts": moe.num_experts,
            "max_abs_err_vs_single_device": err, "rel_err": rel,
            "parity": rel < 5e-5}


def predicted(batch: int = 64, seq: int = 256, eps=(1, 2, 4, 8)) -> list:
    """The decode step by EP degree for scripts/bench_moe.py's MoE: 16
    layers, hidden 2048, 8 experts top-2 of FFN 2816, 16 q / 4 kv heads of
    128, INT8 weights and KV."""
    m = CollectiveCostModel()
    bw = H100_SXM.hbm_bandwidth
    L, D, F, E, topk, HKV, HD = 16, 2048, 2816, 8, 2, 4, 128
    expert_bytes = L * E * 3 * D * F
    qo = (D // HD + 2 * HKV) * HD
    dense_bytes = L * (D * qo + (D // HD) * HD * D) + 2 * 32000 * D
    kv_bytes = 2 * L * batch * seq * HKV * HD
    rows = []
    for ep in eps:
        cap = max(1, int(1.25 * batch * topk / E))
        grid_bytes = E * cap * D * 2                   # bf16 dispatch grid
        hbm = (dense_bytes + expert_bytes / ep + kv_bytes) / bw
        comm = 2 * L * m.all_to_all_time(grid_bytes, ep)
        step = hbm + comm
        rows.append({
            "ep": ep, "step_ms": step * 1e3, "hbm_ms": hbm * 1e3,
            "a2a_ms": comm * 1e3, "tok_s_per_gpu": batch / step,
            "per_gpu_speedup_vs_ep1": (batch / step) * (
                dense_bytes + expert_bytes + kv_bytes) / bw / batch,
        })
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="ep_scaling")
    p.add_argument("--device", default="cuda",
                   help="cuda (one card a rank by LOCAL_RANK) or cpu")
    p.add_argument("--backend", choices=("nccl", "gloo"))
    args = p.parse_args(argv)
    cpu = args.device == "cpu"
    from ..parallel.mesh import default_backend, rank_device

    dev = rank_device(cpu=cpu)
    backend = args.backend or default_backend(dev)
    owned = not dist.is_initialized()
    info = initialize_multihost(backend=backend)
    if info["processes"] == 1 and not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        n = dist.get_world_size()
        # a mesh has an expert axis from two ranks on, as in the JAX package
        mesh = make_mesh(expert=n, backend=backend, device=dev)
        axis = "expert" if n > 1 else "model"
        out = {"metric": "ep_scaling", "executed": executed(mesh, axis),
               "predicted_h100_nvlink": predicted()}
        if mesh.rank == 0:
            print(json.dumps(out))
        return out
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
