"""Quantization accuracy report on a checkpoint, by the protocol of the
repository's `scripts/accuracy_report.py`.

    python3 -m physics_llm_inference_tpu_torch.bench.accuracy --ckpt DIR [--out report.md] [--device cpu]

DIR holds `config.json` (the ModelConfig fields), `params.npz`
(models/loader.save_params format), `heldout.npy` (a token stream) and,
optionally, `tokenizer.json`, as `scripts/train_toy.py` and `bench/train_toy`
write them (the latter also records its tokenizer in `config.json`). The
budget of BASELINE.md (0.1 perplexity, here max(0.1, 0.1% of the fp
perplexity) as the script states it) is checked through every serving
numerics path:

  1. parallel-forward ppl: fp vs INT8-W (bench/perplexity.py);
  2. decode-path ppl: the serving machinery (KV cache, INT8-KV attention,
     on the card the fused decode kernel): fp cache vs INT8 W+KV, then INT4
     W (group-wise, round to nearest) and INT4 with the MSE scale search,
     each over an INT8 cache;
  3. the TokenizerPool round trip with `tokenizer.json` (the `tokenizers`
     package, imported only then), skipped when the file is absent.

One JSON line on stdout; the markdown table only to `--out` when given.
The exit code is 1 when the INT8 deltas break the budget, as the script's
assertions fail. The model runs in float32 on the CPU, as the script runs
it, and in bfloat16 on the card, whose kernels take bf16 activations.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.loader import load_params
from ..models.quant import QuantizedTensor, quantize_params_int4, \
    quantize_params_int8
from ..models.transformer import count_parameters
from .perplexity import decode_path_perplexity, quantization_ppl_report

SAMPLE = "def fused_decode(params, x):\n    return x @ params['w']\n"


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m physics_llm_inference_tpu"
                                 "_torch.bench.accuracy")
    ap.add_argument("--ckpt", default="checkpoints/toy")
    ap.add_argument("--window", type=int, default=256)
    ap.add_argument("--windows", type=int, default=32,
                    help="held-out windows to score")
    ap.add_argument("--out", default=None,
                    help="write the markdown report here (default: none)")
    ap.add_argument("--append", action="store_true",
                    help="append to --out instead of overwriting it")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run on the CPU)")
    return ap.parse_args(argv)


def _cast(tree, dtype):
    """The floating non-quantized leaves of a params tree cast to dtype."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor) or not tree.is_floating_point():
        return tree
    return tree.to(dtype)


def tokenizer_round_trip(ckpt: str) -> dict | None:
    """TokenizerPool with the checkpoint's trained tokenizer: encode SAMPLE
    and decode it back. None when the checkpoint has no tokenizer.json."""
    path = os.path.join(ckpt, "tokenizer.json")
    if not os.path.exists(path):
        return None
    from tokenizers import Tokenizer, decoders

    from ..serve.tokenizer_pool import TokenizerPool

    def factory():
        t = Tokenizer.from_file(path)
        t.decoder = decoders.ByteLevel()  # older checkpoints lack it
        return t

    pool = TokenizerPool(num_workers=2, tokenizer_factory=factory)
    ids = pool.tokenize(SAMPLE)
    return {"ids": len(ids), "exact": pool.detokenize(ids) == SAMPLE}


def report(args) -> dict:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    dtype = "float32" if dev.type == "cpu" else "bfloat16"
    with open(os.path.join(args.ckpt, "config.json")) as f:
        conf = json.load(f)
    # the ModelConfig fields; bench/train_toy also records its tokenizer
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(dtype=dtype, **{k: v for k, v in conf.items()
                                      if k in fields})
    params = _cast(load_params(os.path.join(args.ckpt, "params.npz"),
                               device=dev), getattr(torch, dtype))
    held = np.load(os.path.join(args.ckpt, "heldout.npy"))
    held = held[:args.windows * args.window]
    w = args.window

    params_q = quantize_params_int8(params)
    rep = quantization_ppl_report(params, params_q, cfg, held, window=w)
    dec_fp = decode_path_perplexity(params, cfg, held, window=w)
    dec = {"int8": decode_path_perplexity(params_q, cfg, held, window=w,
                                          kv_dtype=torch.int8)}
    del params_q
    for name, mse in (("int4", False), ("int4_mse", True)):
        dec[name] = decode_path_perplexity(
            quantize_params_int4(params, mse=mse), cfg, held, window=w,
            kv_dtype=torch.int8)
    budget = max(0.1, 1e-3 * rep["ppl_fp"])
    d_dec = dec["int8"] - dec_fp
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "dtype": dtype, "params": count_parameters(params)["total"],
        "heldout_tokens": len(held), "window": w, "budget": budget,
        "forward": rep,
        "decode_fp": dec_fp,
        "decode": {k: {"ppl": v, "delta": v - dec_fp}
                   for k, v in dec.items()},
        "tokenizer": tokenizer_round_trip(args.ckpt),
        "within_budget": abs(rep["delta"]) <= budget and abs(d_dec) <= budget,
    }


def markdown(res: dict, heading: str = "#") -> str:
    b = res["budget"]

    def verdict(delta):
        return "PASS" if abs(delta) <= b else "FAIL"

    fw, fp, dec = res["forward"], res["decode_fp"], res["decode"]
    rows = [("parallel forward (W-only INT8)", fw["ppl_fp"],
             fw["ppl_quantized"], fw["delta"], verdict(fw["delta"])),
            ("decode path (INT8 W+KV)", fp, dec["int8"]["ppl"],
             dec["int8"]["delta"], verdict(dec["int8"]["delta"]))]
    for key, what in (("int4", "INT4 W group-wise + INT8 KV"),
                      ("int4_mse", "INT4 + MSE scale search + INT8 KV")):
        d = dec[key]["delta"]
        rows.append((f"decode path ({what})", fp, dec[key]["ppl"], d,
                     f"{d / fp * 100:+.1f}% rel, measured, not budgeted"))
    tok = res["tokenizer"]
    lines = [
        f"{heading} Quantization accuracy ({res['device']}, {res['dtype']})",
        "",
        f"Model: {res['params'] / 1e6:.1f} M parameters; held-out: "
        f"{res['heldout_tokens']} tokens in windows of {res['window']}.",
        f"Budget: max(0.1 absolute, 0.1% relative) = {b:.4f}, on |delta|.",
        "",
        f"| Path | fp ppl | quant ppl | delta | budget {b:.3f} |",
        "|---|---|---|---|---|",
        *(f"| {p} | {a:.4f} | {q:.4f} | {d:+.4f} | {v} |"
          for p, a, q, d, v in rows),
        "",
        "Tokenizer round trip: " + ("no tokenizer.json" if tok is None else
                                    f"{tok['ids']} ids, exact={tok['exact']}"),
        "",
    ]
    return "\n".join(lines)


def main(argv=None) -> dict:
    args = parse_args(argv)
    res = report(args)
    print(json.dumps(res), flush=True)
    if args.out:
        if os.path.dirname(args.out):
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "a" if args.append else "w") as f:
            f.write(markdown(res, "##" if args.append else "#"))
    return res


if __name__ == "__main__":
    sys.exit(0 if main()["within_budget"] else 1)
