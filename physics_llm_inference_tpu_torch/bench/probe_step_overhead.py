"""The decode step's cost outside the fused decode kernel, by the protocol
of the repository's `scripts/probe_step_overhead.py`.

    python3 -m physics_llm_inference_tpu_torch.bench.probe_step_overhead [--model 7b] [--batch 64] [--seq 256] [--steps 64] [--start 128]

bench.py's step is embed -> K4 (`fused_decode_step`, every layer) -> final
RMSNorm -> lm_head -> argmax or sample. This probe times K4 alone, then
adds the other pieces one at a time, each variant `--steps` steps captured
in one CUDA graph (bench/attribution.time_steps), so each piece's marginal
cost is a difference of two device times:

  kernel only                  K4 at slots start .. start + steps - 1,
                               its output renormalised into the next input
  + norm/lm_head/argmax        `lm_logits` (RMSNorm, K1 on the lm_head)
                               and an argmax folded back into the input,
                               as the script adds them
  + head (K3)                  the main path's head instead: K3
                               (`lmhead_greedy`: norm, head and argmax in
                               one kernel)
  + embed (K3)                 the token's embedding as the input
  full step (embed+sample)     embed, K4, `lm_logits`, `sample_token`
                               (temperature 0 rows), the script's full step

INT8 weights from seed 0 (`init_params_int8`), random INT8 caches of
`--seq` slots. One JSON line on stdout: each variant's ms a step and the
marginal ms of each piece.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..kernels.fused_decode import fused_decode_step
from ..kernels.lmhead import lmhead_greedy
from ..models.config import ModelConfig
from ..models.quant import init_params_int8
from ..models.transformer import embed_lookup, lm_logits
from ..ops.rope import rope_frequencies
from ..ops.sampling import sample_token
from .attribution import time_steps
from .headline import device_of, log
from .headline import SHAPES


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m physics_llm_inference_tpu"
                                 "_torch.bench.probe_step_overhead")
    ap.add_argument("--model", default="7b", choices=sorted(SHAPES))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--start", type=int, default=128)
    return ap.parse_args(argv)


def main(argv=(), device="cuda", cfg: ModelConfig | None = None) -> dict:
    args = parse_args(list(argv))
    dev = device_of(device)
    cfg = cfg or ModelConfig(vocab_size=32000, max_seq_len=2048,
                             dtype="bfloat16", **SHAPES[args.model])
    B, S, L = args.batch, args.seq, cfg.num_layers
    if args.start + args.steps > S:
        raise ValueError("--start + --steps must stay inside --seq")
    flat = cfg.num_kv_heads * cfg.head_dim
    params = init_params_int8(torch.Generator(device=dev).manual_seed(0), cfg)
    blocks, lm = params["blocks"], params["lm_head"]
    g = torch.Generator(device=dev).manual_seed(1)
    kq = torch.randint(-127, 128, (L, B, S, flat), dtype=torch.int8,
                       generator=g, device=dev)
    vq = torch.randint(-127, 128, (L, B, S, flat), dtype=torch.int8,
                       generator=g, device=dev)
    ks = torch.full((L, B, cfg.num_kv_heads, S), 0.05, device=dev)
    vs = torch.full((L, B, cfg.num_kv_heads, S), 0.05, device=dev)
    dt = params["embed"].dtype
    x0 = torch.randn((B, cfg.hidden_dim), generator=g, device=dev).to(dt)
    cos_t, sin_t = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                    cfg.rope_theta, device=dev)
    vfrom = torch.zeros(B, dtype=torch.int32, device=dev)
    temps = torch.zeros(B, device=dev)    # greedy rows, through the sampler
    x = x0.clone()
    tok = torch.zeros(B, dtype=torch.long, device=dev)
    i = torch.zeros((), dtype=torch.long, device=dev)   # the step index

    def kernel(xin):
        slot = (args.start + i).expand(B)
        x_out, *_ = fused_decode_step(
            blocks, xin, kq, ks, vq, vs, slot, vfrom, cos_t[slot],
            sin_t[slot], cfg, slot=slot, write_cache=True)
        i.add_(1).remainder_(args.steps)
        return x_out

    def renorm(x_out):
        xf = x_out.float()
        return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
                ).to(dt)

    def v_kernel():
        x.copy_(renorm(kernel(x)))

    def v_lmhead():
        x_out = kernel(x)
        nxt = torch.argmax(lm_logits(x_out[:, None, :], params, cfg)[:, 0],
                           dim=-1)
        x.copy_(renorm(x_out) + ((nxt[:, None] % 3) * 0).to(dt))

    def v_k3():
        x_out = kernel(x)
        nxt = lmhead_greedy(x_out, params["norm"], lm.q, lm.s,
                            eps=cfg.norm_eps)
        x.copy_(renorm(x_out) + ((nxt[:, None] % 3) * 0).to(dt))

    def v_embed_k3():
        x_out = kernel(embed_lookup(params, tok, cfg))
        tok.copy_(lmhead_greedy(x_out, params["norm"], lm.q, lm.s,
                                eps=cfg.norm_eps))

    def v_full():
        x_out = kernel(embed_lookup(params, tok, cfg))
        logits = lm_logits(x_out[:, None, :], params, cfg)[:, 0]
        tok.copy_(sample_token(logits, None, temperature=temps,
                               top_p=None))

    variants = {"kernel only": v_kernel,
                "+ norm/lm_head/argmax": v_lmhead,
                "+ head (K3)": v_k3,
                "+ embed (K3)": v_embed_k3,
                "full step (embed+sample)": v_full}
    rows = {}
    for name, fn in variants.items():
        i.zero_()
        x.copy_(x0)
        rows[name] = time_steps(fn, args.steps, dev) * 1e3
        log(f"{name:28s} per-step {rows[name]:7.3f} ms")
    k = rows["kernel only"]
    out = {"metric": "probe_step_overhead", "ms_per_step": rows,
           "marginal_ms": {
               "norm/lm_head/argmax": rows["+ norm/lm_head/argmax"] - k,
               "head (K3)": rows["+ head (K3)"] - k,
               "embed": rows["+ embed (K3)"] - rows["+ head (K3)"],
               "sampling": rows["full step (embed+sample)"]
               - rows["+ norm/lm_head/argmax"]
               - (rows["+ embed (K3)"] - rows["+ head (K3)"]),
               "outside the kernel (full step)":
                   rows["full step (embed+sample)"] - k,
               "outside the kernel (main path: embed, K3)":
                   rows["+ embed (K3)"] - k},
           "config": {"model": args.model, "batch": B, "seq": S,
                      "steps": args.steps, "start": args.start},
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
