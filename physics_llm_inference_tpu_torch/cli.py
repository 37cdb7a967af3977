"""Command-line entry points: serve / bench / generate (counterpart:
physics_llm_inference_tpu/cli.py, with the same presets).

  python -m physics_llm_inference_tpu_torch.cli serve --config llama7b --int8 [--paged]
  python -m physics_llm_inference_tpu_torch.cli bench [--config small] [--requests 16]
  python -m physics_llm_inference_tpu_torch.cli generate --prompt "..." [--max-tokens N]

Configs are named presets (toy/small/1b/llama7b/qwen3) initialized from seed
0; --int8 quantizes the weights (models/quant.quantize_params_int8). Every
command runs on the card; `--device cpu` is the only way onto the CPU, and
without CUDA and that flag the command exits with an error. Not ported:
--ckpt and --hf (the loader, ROADMAP Queue A item 4) and --tp/--dp above 1
(parallel serving, Queue A item 7) raise.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def _named_config(name: str):
    from .models.config import (LLAMA_7B_CONFIG, QWEN3_CONFIG, TOY_CONFIG,
                                ModelConfig)

    presets = {
        "toy": TOY_CONFIG,
        "small": ModelConfig(vocab_size=8192, hidden_dim=512, num_layers=8,
                             num_heads=8, num_kv_heads=2,
                             intermediate_dim=1408, max_seq_len=1024,
                             dtype="bfloat16"),
        "1b": ModelConfig(vocab_size=32000, hidden_dim=2048, num_layers=16,
                          num_heads=16, num_kv_heads=4,
                          intermediate_dim=5632, max_seq_len=2048,
                          dtype="bfloat16"),
        "llama7b": LLAMA_7B_CONFIG,
        "qwen3": QWEN3_CONFIG,
    }
    if name not in presets:
        raise SystemExit(f"unknown config '{name}'; choose from "
                         f"{sorted(presets)}")
    return presets[name]


def _device(args) -> torch.device:
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    return torch.device(args.device)


def _load_model(args):
    from .models.quant import quantize_params_int8
    from .models.transformer import init_params

    if args.hf or args.ckpt:
        raise NotImplementedError("--ckpt and --hf need the checkpoint "
                                  "loader, which is not ported yet (ROADMAP "
                                  "Queue A item 4)")
    cfg = _named_config(args.config)
    dev = _device(args)
    print(f"[cli] random-init {args.config} "
          f"({cfg.param_count()/1e6:.0f}M params) on {dev}", file=sys.stderr)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    if args.int8:
        params = quantize_params_int8(params)
    return params, cfg


def _add_model_args(p):
    p.add_argument("--config", default="small")
    p.add_argument("--ckpt", help="native .npz checkpoint (not ported)")
    p.add_argument("--hf", help="HF safetensors directory (not ported)")
    p.add_argument("--int8", action="store_true",
                   help="INT8 weight-only quantization")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu to run on the CPU)")


def cmd_serve(args):
    from .serve import EngineConfig, InferenceEngine
    from .serve.http_server import InferenceServer

    if args.tp > 1 or args.dp > 1:
        raise NotImplementedError("--tp/--dp above 1 need parallel serving, "
                                  "which is not ported yet (ROADMAP Queue A "
                                  "item 7)")
    params, cfg = _load_model(args)
    if args.paged:
        from .serve.paged_engine import (PagedEngineConfig,
                                         PagedInferenceEngine)

        # a geometry the fused paged kernel takes (blocks a multiple of 128
        # tokens); fine blocks only when the context window itself is
        # smaller than such a block
        if args.max_seq_len % 128 == 0:
            pc = PagedEngineConfig.for_fused(max_batch=args.slots,
                                             max_seq_len=args.max_seq_len)
        else:
            pc = PagedEngineConfig(
                max_batch=args.slots,
                num_blocks=args.slots * ((args.max_seq_len + 15) // 16),
                block_size=16,
                max_blocks_per_request=(args.max_seq_len + 15) // 16)
        engine = PagedInferenceEngine(params, cfg, pc)
    else:
        engine = InferenceEngine(params, cfg, EngineConfig(
            num_slots=args.slots, max_seq_len=args.max_seq_len))
    server = InferenceServer(engine, host=args.host, port=args.port,
                             model_name=args.config)
    print(f"[cli] serving on http://{args.host}:{server.port}",
          file=sys.stderr)
    if args.check:
        # validation mode: engine and server are built (port bound), but no
        # request loop starts
        server.close()
        print("[cli] check ok", file=sys.stderr)
        return
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


def cmd_generate(args):
    from .runtime.generate import cached_generate
    from .serve.tokenizer_pool import TokenizerPool

    params, cfg = _load_model(args)
    tok = TokenizerPool(num_workers=1)
    prompt = tok.tokenize(args.prompt)
    gen = torch.Generator(device=params["embed"].device).manual_seed(0)
    out = cached_generate(params, cfg, [prompt], args.max_tokens,
                          generator=gen, temperature=args.temperature)
    print(tok.detokenize([int(t) for t in out.tokens[0]]))
    print(f"[cli] ttft {out.prefill_s*1e3:.1f} ms, "
          f"{out.decode_tokens_per_s:.1f} tok/s", file=sys.stderr)


def cmd_bench(args):
    from .bench.harness import BenchmarkConfig, run_benchmark
    from .runtime.generate import cached_generate

    params, cfg = _load_model(args)

    def generate_fn(prompt, max_tokens):
        out = cached_generate(params, cfg, [prompt], max_tokens,
                              temperature=0.0)
        return {"tokens": list(out.tokens[0]), "ttft_s": out.prefill_s}

    res = run_benchmark(BenchmarkConfig(
        num_requests=args.requests, concurrency=1,
        prompt_len=args.prompt_len, max_tokens=args.max_tokens), generate_fn)
    print(res.summary(), file=sys.stderr)
    print(json.dumps(res.to_dict()))


def main(argv=None):
    p = argparse.ArgumentParser(prog="physics_llm_inference_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="run the OpenAI-compatible HTTP server")
    _add_model_args(s)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--slots", type=int, default=8)
    s.add_argument("--max-seq-len", type=int, default=1024)
    s.add_argument("--paged", action="store_true",
                   help="paged-KV engine with radix prefix cache")
    s.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (not ported: must be 1)")
    s.add_argument("--dp", type=int, default=1,
                   help="data-parallel ways (not ported: must be 1)")
    s.add_argument("--check", action="store_true",
                   help="construct engine+server, then exit — config "
                        "validation")
    s.set_defaults(fn=cmd_serve)

    g = sub.add_parser("generate", help="one-shot generation")
    _add_model_args(g)
    g.add_argument("--prompt", required=True)
    g.add_argument("--max-tokens", type=int, default=64)
    g.add_argument("--temperature", type=float, default=0.0)
    g.set_defaults(fn=cmd_generate)

    b = sub.add_parser("bench", help="serving benchmark")
    _add_model_args(b)
    b.add_argument("--requests", type=int, default=16)
    b.add_argument("--prompt-len", type=int, default=64)
    b.add_argument("--max-tokens", type=int, default=32)
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
