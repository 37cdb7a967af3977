"""Scaling benchmark: a TP decode step and a DP step timed on the mesh the
caller built, beside the NVLink cost model's prediction (counterpart:
physics_llm_inference_tpu/bench/scaling.py).

The JAX package builds each mesh itself on one process's devices; here
each rank of an initialized world calls the measurement on its mesh, and
a scaling curve takes one world a width (`add_efficiency` joins them).
Ranks that share one card measure correctness and host overhead, not
scaling. The predictions are data-sheet arithmetic (specs/nvlink.py,
specs/gpu.py), not measurements.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.transformer import KVSlice, forward, init_params
from ..parallel.tp import tp_local_config, tp_prepare_params
from ..runtime.kv_cache import KVCache
from ..specs.gpu import H100_SXM, GPUSpec
from ..specs.nvlink import NETWORK_GBPS, NETWORK_LATENCY_S, \
    CollectiveCostModel


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _step_ms(step, dev, iters: int, mesh) -> tuple[float, float]:
    """(ms a step, the share of it in the mesh's collectives) over
    `iters` steps after one warm-up step."""
    step()
    _sync(dev)
    mesh.time_collectives()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    _sync(dev)
    wall = time.perf_counter() - t0
    share = mesh.comm_s / wall if wall else 0.0
    mesh.time_collectives(False)
    return wall / iters * 1e3, share


def measure_tp_decode(cfg: ModelConfig, mesh, batch: int = 8,
                      cache_len: int = 256, iters: int = 10,
                      seed: int = 0) -> dict:
    """A decode step over the whole batch, tensor-parallel on the mesh's
    `model` axis: every rank builds the weights from `seed`, keeps its
    shard and decodes against a half-full cache of its KV heads. Returns
    {tp: {"step_ms", "collective_share"}}."""
    dev = mesh.device
    tp = mesh.size("model")
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    local = tp_prepare_params(params, cfg, mesh)
    del params
    lcfg = tp_local_config(cfg, tp, data_axis=None, mesh=mesh) \
        if tp > 1 else cfg
    cache = KVCache.create(lcfg, batch, cache_len, device=dev)
    tok = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
    lens = torch.full((batch,), cache_len // 2, dtype=torch.int32,
                      device=dev)

    def step():
        forward(local, tok, lcfg, kv=KVSlice(cache.k, cache.v, lens),
                last_only=True)

    ms, share = _step_ms(step, dev, iters, mesh)
    return {tp: {"step_ms": ms, "collective_share": share}}


def measure_dp_step(cfg: ModelConfig, mesh, batch_per_replica: int = 4,
                    cache_len: int = 128, iters: int = 10,
                    seed: int = 0) -> dict:
    """A decode step data-parallel on the mesh's `data` axis: weights
    replicated, each rank its own batch_per_replica rows, the sampled
    tokens gathered over `data` as the slot engine gathers them. Returns
    {dp: {"step_ms", "tokens_per_step", "collective_share"}}."""
    dev = mesh.device
    dp = mesh.size("data")
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    cache = KVCache.create(cfg, batch_per_replica, cache_len, device=dev)
    tok = torch.zeros((batch_per_replica, 1), dtype=torch.int64, device=dev)
    lens = torch.full((batch_per_replica,), cache_len // 2,
                      dtype=torch.int32, device=dev)

    def step():
        logits, _ = forward(params, tok, cfg,
                            kv=KVSlice(cache.k, cache.v, lens),
                            last_only=True)
        nxt = logits[:, 0].argmax(-1)
        if dp > 1:
            mesh.all_gather(nxt, "data", dim=0)

    ms, share = _step_ms(step, dev, iters, mesh)
    return {dp: {"step_ms": ms, "tokens_per_step": dp * batch_per_replica,
                 "collective_share": share}}


def add_efficiency(results: dict, batch_per_replica: int | None = None
                   ) -> dict:
    """Efficiency of each width against width 1, as the JAX package
    reports it: TP (ideal step time t1/n) by default; DP (throughput
    against n times one replica's) with batch_per_replica."""
    if 1 not in results:
        return results
    t1 = results[1]["step_ms"]
    for n, r in results.items():
        if batch_per_replica is None:
            r["efficiency"] = (t1 / n) / r["step_ms"]
        else:
            thru = r["tokens_per_step"] / r["step_ms"]
            r["efficiency"] = thru / (n * batch_per_replica / t1)
    return results


def predict_scaling(cfg: ModelConfig, batch: int = 8,
                    mesh_sizes=(1, 2, 4, 8, 16), over_network_from: int = 16,
                    weight_dtype_bytes: int = 1,
                    spec: GPUSpec = H100_SXM) -> dict:
    """The cost model's TP decode step by width: weights streamed at the
    data sheet's HBM rate, split n ways, against two activation
    all-reduces a layer over NVLink (over the network from
    `over_network_from` GPUs, past one 8-GPU node)."""
    model = CollectiveCostModel(spec)
    weight_bytes = cfg.param_count() * weight_dtype_bytes
    out = {}
    for n in mesh_sizes:
        compute = weight_bytes / n / spec.hbm_bandwidth
        act = batch * cfg.hidden_dim * 2
        comm = 2 * cfg.num_layers * model.all_reduce_time(
            act, n, over_network=n >= over_network_from)
        step = max(compute, comm) if n > 1 else compute
        out[n] = {
            "predicted_step_ms": step * 1e3,
            "compute_ms": compute * 1e3,
            "comm_ms": comm * 1e3,
            "efficiency": compute / step if step else 1.0,
        }
    return out


def predict_dp_scaling(cfg: ModelConfig, batch_per_replica: int = 64,
                       hosts=(1, 2, 4, 8, 16), weight_dtype_bytes: int = 1,
                       admission_bytes: int = 4096,
                       network_gbps: float = NETWORK_GBPS,
                       spec: GPUSpec = H100_SXM) -> dict:
    """The cost model's DP serving by replica count: each replica's step is
    the one-GPU step (weights replicated), and the one cross-replica cost
    a step is the admission broadcast (parallel/multihost.py)."""
    step_s = cfg.param_count() * weight_dtype_bytes / spec.hbm_bandwidth
    bw = network_gbps / 2 * 1e9
    out = {}
    for n in hosts:
        bcast = 0.0 if n == 1 else (admission_bytes * (n - 1) / n / bw
                                    + NETWORK_LATENCY_S * np.log2(n))
        tot = step_s + bcast
        out[n] = {
            "predicted_step_ms": tot * 1e3,
            "broadcast_ms": bcast * 1e3,
            "tokens_per_s": n * batch_per_replica / tot,
            "efficiency": step_s / tot,
        }
    return out
