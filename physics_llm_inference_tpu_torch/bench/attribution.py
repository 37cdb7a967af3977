"""Decode-step cost attribution (counterpart:
physics_llm_inference_tpu/bench/attribution.py).

The headline bench times the whole decode step; this bench times its parts
alone, on the per-op decode path, so the gap to the memory floor can be
attributed:

  matmuls   : the 4 INT8 linears of every layer through the model's
              `_linear` (K1's "stream" route at decode rows) and the
              lm_head. Floor: int8 weight bytes over the HBM rate.
  attention : K2 (`int8_kv_decode_attention`) over the full stacked INT8
              caches, every layer. Floor: the live KV bytes.
  glue      : everything else (norms, RoPE, the KV quantize and write,
              silu, residuals, the argmax): the per-op step
              (`models/transformer.forward` with the cache, greedy argmax)
              less the matmuls and the attention, cross-checked by the glue
              alone (the JAX module's glue-only step: matmuls and attention
              replaced by shape-preserving broadcasts) as `glue_alone_s`.

Each part runs `steps` steps captured in one CUDA graph (the form of the
JAX module's `lax.scan` inside one jit); the graph is replayed between CUDA
events, the first replay dropped and the median of the rest kept, per
step. On the CPU (tests) the steps run eagerly under the host clock. The
state each step carries (the activations, the token) lives in static
tensors the step writes, so each replay continues from the last.

    python3 -m physics_llm_inference_tpu_torch.bench.attribution [--batch 32] [--cache-len 256] [--steps 64]

One JSON line on stdout, the table on stderr.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch
import torch.nn.functional as F

from ..kernels.int8_kv_attention import int8_kv_decode_attention
from ..kernels.quant import quantize_int8
from ..models.config import ModelConfig
from ..models.quant import QuantizedTensor, quantize_params_int8
from ..models.transformer import (KVSlice, QuantKV, _linear, forward,
                                  init_params, layer_view)
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_frequencies
from ..specs.gpu import GPUSpec, get_gpu_spec
from .headline import device_of, log


def time_steps(step, steps: int, device, repeats: int = 3,
               best: bool = False) -> float:
    """Seconds a step of `step()`: on CUDA `steps` calls captured in one
    graph and replayed between CUDA events, on the CPU `steps` eager calls
    under the host clock; `repeats` + 1 runs with the first dropped and the
    median of the rest kept, or with `best` the least of `repeats` runs."""
    device = torch.device(device)

    def run():
        for _ in range(steps):
            step()

    graph = None
    if device.type == "cuda":
        from ..runtime.step_cache import CapturedStep

        graph = CapturedStep(run, device)
    times = []
    for _ in range(repeats if best else repeats + 1):
        if graph is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            graph()
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]) / 1e3 / steps)
        else:
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) / steps)
    if best:
        return min(times)
    times = sorted(times[1:])
    return times[len(times) // 2]


def default_config() -> ModelConfig:
    """The JAX module's default: hidden 2048, 16 layers, 16 q / 4 kv
    heads, FFN 5632, vocab 32000, bf16."""
    return ModelConfig(vocab_size=32000, hidden_dim=2048, num_layers=16,
                       num_heads=16, num_kv_heads=4, intermediate_dim=5632,
                       max_seq_len=2048, dtype="bfloat16")


def weight_bytes(params) -> int:
    """The int8 weight bytes the matmuls read: every int8 block leaf and
    the lm_head's, as the JAX module counts them."""
    n = sum(w.q.numel() for w in params["blocks"].values()
            if isinstance(w, QuantizedTensor))
    lm = params["lm_head"]
    return n + (lm.q.numel() if isinstance(lm, QuantizedTensor)
                else lm.numel())


def kv_bytes(cfg: ModelConfig, batch: int, cache_len: int) -> int:
    """Both INT8 caches with their f32 scales: 2 x (L·B·S·Hkv·hd + 4 L·B·
    Hkv·S), as the JAX module's 2 * (kq.nbytes + ks.nbytes)."""
    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    return 2 * (L * batch * cache_len * hkv * hd
                + 4 * L * batch * hkv * cache_len)


def attribute_decode(cfg: ModelConfig | None = None, batch: int = 32,
                     cache_len: int = 256, steps: int = 64, device="cuda",
                     spec: GPUSpec | None = None) -> dict:
    """The three parts of a per-op decode step at `batch` rows over caches
    of `cache_len` slots, seconds a step, each beside its byte floor on
    `spec` (default the card's)."""
    dev = device_of(device)
    cfg = cfg or default_config()
    spec = spec or get_gpu_spec()
    params = quantize_params_int8(init_params(
        torch.Generator(device=dev).manual_seed(0), cfg))
    L, d, f = cfg.num_layers, cfg.hidden_dim, cfg.intermediate_dim
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    B, S = batch, cache_len
    dt = params["embed"].dtype
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((B, d), generator=g, device=dev).to(dt)

    # --- matmuls only: the model's _linear over the stacked weights ---
    def matmul_step():
        h = x
        for l in range(L):
            bp = layer_view(params["blocks"], l)
            qkv = _linear(h, bp["wqkv"])
            h = h + _linear(qkv[:, :hq * hd].contiguous(), bp["wo"])
            gu = _linear(h, bp["w_gate_up"])
            h = h + _linear(gu[:, :f].contiguous(), bp["w_down"])
        y = _linear(h, params["lm_head"])
        h = h + y[:, :d].to(dt) * 1e-6          # keeps the lm_head live
        # renormalise once a step: a chain of unscaled products overflows
        hf = h.float()
        x.copy_(hf * torch.rsqrt((hf * hf).mean() + 1e-6))

    t_matmul = time_steps(matmul_step, steps, dev)

    # --- attention only: K2 over the full stacked caches ---
    kq = torch.randint(-127, 127, (L, B, S, hkv * hd), dtype=torch.int8,
                       generator=g, device=dev)
    vq = torch.randint(-127, 127, (L, B, S, hkv * hd), dtype=torch.int8,
                       generator=g, device=dev)
    ks = torch.full((L, B, hkv, S), 0.05, device=dev)
    vs = torch.full((L, B, hkv, S), 0.05, device=dev)
    qslot = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    q = torch.randn((B, hq, hd), generator=g, device=dev).to(dt)

    def attn_step():
        o = q
        for l in range(L):
            o = int8_kv_decode_attention(o, kq, ks, vq, vs, qslot, layer=l)
        q.copy_(o)

    t_attn = time_steps(attn_step, steps, dev)

    # --- the per-op decode step: forward at slot S - 1 of those caches ---
    step_cfg = dataclasses.replace(cfg, fused_decode=False)
    tok = torch.randint(1, cfg.vocab_size, (B,), generator=g, device=dev)
    slot = torch.full((B,), S - 1, dtype=torch.long, device=dev)
    vfrom = torch.zeros(B, dtype=torch.int32, device=dev)
    kv = KVSlice(QuantKV(kq, ks), QuantKV(vq, vs), slot)

    def full_step():
        logits, _ = forward(params, tok[:, None], step_cfg, kv=kv,
                            positions=slot[:, None], slots=slot[:, None],
                            valid_from=vfrom, last_only=True)
        tok.copy_(torch.argmax(logits[:, -1], dim=-1))

    t_full = time_steps(full_step, steps, dev)

    # --- glue alone: the JAX module's glue step ---
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, cfg.rope_theta,
                                device=dev)
    kcache = torch.zeros((L, B, S, hkv, hd), dtype=torch.int8, device=dev)
    kscale = torch.zeros((L, B, hkv, S), device=dev)
    pos = torch.full((B, 1), S - 1, dtype=torch.long, device=dev)
    xg = x.clone()
    ones = torch.ones((B, 1, hkv, hd), dtype=dt, device=dev)

    def glue_step():
        h0 = xg
        for l in range(L):
            h = rms_norm(h0[:, None], params["blocks"]["ln1"][l],
                         cfg.norm_eps)
            qg = h[:, :, None, :hd].expand(B, 1, hq, hd)
            k = h[:, :, None, :hd] * ones
            qg = apply_rope(qg, cos, sin, pos)
            k = apply_rope(k, cos, sin, pos)
            knew, ksnew = quantize_int8(k, axis=-1)
            kcache[l, :, S - 1] = knew[:, 0]
            kscale[l, :, :, S - 1] = ksnew[:, 0, :, 0]
            h0 = h0 + qg.reshape(B, hq * hd)[:, :d]
            h2 = rms_norm(h0[:, None], params["blocks"]["ln2"][l],
                          cfg.norm_eps)
            gate = h2[:, 0, :, None].expand(B, d, 2).reshape(B, -1)[:, :f]
            h0 = h0 + (F.silu(gate) * gate)[:, :d]
        logits = h0[:, :1].expand(B, cfg.vocab_size).float()
        nxt = torch.argmax(logits, dim=-1)
        xg.copy_(h0 + (nxt[:, None] * 0).to(dt))

    t_glue_alone = time_steps(glue_step, steps, dev)

    wb, kvb = weight_bytes(params), kv_bytes(cfg, B, S)
    t_glue = t_full - t_matmul - t_attn
    return {
        "matmul_s": t_matmul,
        "matmul_floor_s": wb / spec.hbm_bandwidth,
        "matmul_eff": wb / spec.hbm_bandwidth / t_matmul,
        "attn_s": t_attn,
        "attn_floor_s": kvb / spec.hbm_bandwidth,
        "attn_eff": kvb / spec.hbm_bandwidth / t_attn,
        "glue_s": t_glue,
        "glue_alone_s": t_glue_alone,
        "full_s": t_full,
        "sum_s": t_matmul + t_attn + t_glue,
        "weight_bytes": wb,
        "kv_bytes": kvb,
        "config": {"batch": B, "cache_len": S, "steps": steps,
                   "layers": L, "hidden": d},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m physics_llm_inference_tpu"
                                 "_torch.bench.attribution")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=64)
    return ap.parse_args(argv)


def main(argv=(), device="cuda", cfg: ModelConfig | None = None,
         spec: GPUSpec | None = None) -> dict:
    args = parse_args(list(argv))
    r = attribute_decode(cfg, args.batch, args.cache_len, args.steps,
                         device, spec)
    log(f"{'component':<12}{'ms/step':>10}{'floor ms':>10}{'% of BW':>9}")
    for name in ("matmul", "attn"):
        log(f"{name:<12}{r[name + '_s'] * 1e3:>10.3f}"
            f"{r[name + '_floor_s'] * 1e3:>10.3f}"
            f"{r[name + '_eff'] * 100:>8.1f}%")
    log(f"{'glue':<12}{r['glue_s'] * 1e3:>10.3f} (alone "
        f"{r['glue_alone_s'] * 1e3:.3f})")
    log(f"{'full step':<12}{r['full_s'] * 1e3:>10.3f}")
    log(f"weights {r['weight_bytes'] / 1e6:.0f} MB, KV "
        f"{r['kv_bytes'] / 1e6:.0f} MB")
    print(json.dumps(r), flush=True)
    return r


if __name__ == "__main__":
    main(sys.argv[1:])
