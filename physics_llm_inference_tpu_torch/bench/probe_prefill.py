"""Prefill (TTFT) attribution at the 7B headline shape, by the protocol of
the repository's `scripts/probe_prefill.py`.

    python3 -m physics_llm_inference_tpu_torch.bench.probe_prefill [--batch 64] [--prompt 128] [--layers 8] [--arms full,int8,k1,bf16]

The prefill of `bench.py` is one batched forward of 64 x 128 tokens. The
arms, each captured as a CUDA graph and timed by CUDA events (the least of
3 replays, as the script takes the least of 3), at `--layers` layers of the
7B widths:

  full   the prefill forward (`models/transformer.forward` over an INT8
         cache of prompt + 8 slots, last position's logits)
  int8   the matmuls alone, on the same INT8 weights, through the model's
         `_linear` (at B x prompt >= 2,048 rows the port's prefill route:
         the int8 weights cast to bf16 into a library GEMM with f32 output,
         as the JAX package leaves it to XLA)
  k1     the same matmuls through K1's "wgmma" route (`int8_matmul`),
         which `_linear` takes below 2,048 rows
  bf16   the same matmuls on one layer's int8 values cast to bf16
         beforehand (as the script's arm), `torch.mm`, run `--layers`
         times
  FLOP   the matmuls' (and attention's) FLOP over the bf16 peak of the
         port's `GPUSpec`: the floor

The script's `parts` and `glue2` arms (TPU glue rewrites of RoPE and silu)
are not ported. One JSON line on stdout, the script's report on stderr.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.int8_matmul import _launch, int8_matmul
from ..models.config import ModelConfig
from ..models.quant import QuantizedTensor, init_params_int8
from ..models.transformer import _linear, forward, layer_view
from ..runtime.kv_cache import KVCache
from ..specs.gpu import GPUSpec, get_gpu_spec
from .attribution import time_steps
from .headline import device_of, log

ARMS = ("full", "int8", "k1", "bf16")


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m physics_llm_inference_tpu"
                                 "_torch.bench.probe_prefill")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--layers", type=int, default=8,
                    help="timed layers (the report is per this depth)")
    ap.add_argument("--arms", default=",".join(ARMS),
                    help="comma list of arms to run")
    return ap.parse_args(argv)


def flops(cfg: ModelConfig, batch: int, prompt: int) -> dict:
    """The script's FLOP counts: the four linears of every layer over B x P
    tokens, the lm_head at the last position, causal-free attention."""
    T, L = batch * prompt, cfg.num_layers
    D, Fd = cfg.hidden_dim, cfg.intermediate_dim
    QH = cfg.num_heads * cfg.head_dim
    QO = QH + 2 * cfg.num_kv_heads * cfg.head_dim
    return {"matmul": 2 * T * L * (D * QO + QH * D + 2 * D * Fd + Fd * D),
            "lm_head": 2 * batch * D * cfg.vocab_size,
            "attention": 2 * 2 * batch * cfg.num_heads * prompt * prompt
            * cfg.head_dim * L}


def main(argv=(), device="cuda", cfg: ModelConfig | None = None,
         spec: GPUSpec | None = None) -> dict:
    args = parse_args(list(argv))
    arms = set(args.arms.split(","))
    dev = device_of(device)
    spec = spec or get_gpu_spec()
    L = args.layers
    cfg = cfg or ModelConfig(vocab_size=32000, max_seq_len=1024,
                             dtype="bfloat16", hidden_dim=4096, num_layers=L,
                             num_heads=32, num_kv_heads=8,
                             intermediate_dim=11008)
    B, P = args.batch, args.prompt
    D, Fd = cfg.hidden_dim, cfg.intermediate_dim
    QH = cfg.num_heads * cfg.head_dim
    params = init_params_int8(torch.Generator(device=dev).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, P))).to(dev)
    fl = flops(cfg, B, P)
    times = {}

    if "full" in arms:
        cache = KVCache.create(cfg, B, P + 8, dtype=torch.int8, device=dev)

        def full():
            return forward(params, ids, cfg, kv=cache.as_slice(),
                           last_only=True)[0]

        times["full"] = time_steps(full, 1, dev, best=True)
    bl = params["blocks"]
    x = (torch.randn((B * P, D), generator=torch.Generator(device=dev)
                     .manual_seed(1), device=dev)).to(params["embed"].dtype)

    def matmuls(linear):
        def run():
            h = x
            for l in range(L):
                bp = layer_view(bl, l)
                qkv = linear(h, bp["wqkv"])
                o = linear(qkv[:, :QH].contiguous(), bp["wo"])
                gu = linear(h + o, bp["w_gate_up"])
                dn = linear((F.silu(gu[:, :Fd]) * gu[:, Fd:]).contiguous(),
                            bp["w_down"])
                h = h + dn
            return h
        return run

    def k1(h, w: QuantizedTensor):
        if h.is_cuda:
            return _launch("wgmma", h, w.q, w.s.reshape(1, -1))
        return int8_matmul(h, w.q, w.s)   # the plain version on the CPU

    if "int8" in arms:
        times["int8"] = time_steps(matmuls(_linear), 1, dev, best=True)
    if "k1" in arms:
        times["k1"] = time_steps(matmuls(k1), 1, dev, best=True)
    if "bf16" in arms:
        # one layer's int8 values cast to bf16, as the script's arm
        ws = {n: bl[n].q[0].to(x.dtype)
              for n in ("wqkv", "wo", "w_gate_up", "w_down")}

        def bf16():
            h = x
            for l in range(L):
                h = h + float(l) * 1e-8
                qkv = torch.mm(h, ws["wqkv"])
                o = torch.mm(qkv[:, :QH], ws["wo"])
                gu = torch.mm(h + o, ws["w_gate_up"])
                h = h + torch.mm(F.silu(gu[:, :Fd]) * gu[:, Fd:],
                                 ws["w_down"])
            return h

        times["bf16"] = time_steps(bf16, 1, dev, best=True)

    peak = spec.peak_flops
    total = fl["matmul"] + fl["attention"] + fl["lm_head"]

    def rate(key, n):
        t = times.get(key)
        return None if t is None else {"ms": t * 1e3, "tflops": n / t / 1e12,
                                       "of_peak": n / t / peak}

    out = {"metric": "probe_prefill",
           "full": rate("full", total),
           "int8": rate("int8", fl["matmul"]),
           "k1": rate("k1", fl["matmul"]),
           "bf16": rate("bf16", fl["matmul"]),
           "floor_ms": fl["matmul"] / peak * 1e3,
           "flops": fl,
           "rest_ms": ((times["full"] - times["int8"]) * 1e3
                       if "full" in times and "int8" in times else None),
           "config": {"batch": B, "prompt": P, "layers": L},
           "spec": spec.name,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    log(f"shapes: B={B} P={P} L={L} (per-{L}-layer figures)")
    log(f"matmul FLOP {fl['matmul'] / 1e12:.2f} T, attention "
        f"{fl['attention'] / 1e12:.3f} T, floor {out['floor_ms']:.2f} ms "
        f"on {spec.name}")
    for key, what in (("full", "full prefill"), ("int8", "matmuls, int8 "
                      "path"), ("k1", "matmuls, K1 wgmma"),
                      ("bf16", "matmuls, bf16 torch.mm")):
        r = out[key]
        if r is not None:
            log(f"{what:24s} {r['ms']:8.2f} ms ({r['tflops']:.0f} TF/s, "
                f"{r['of_peak'] * 100:.0f}% of peak)")
    if out["rest_ms"] is not None:
        log(f"attention + glue + lm_head = full - int8 matmuls: "
            f"{out['rest_ms']:.2f} ms")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
