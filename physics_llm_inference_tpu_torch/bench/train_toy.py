"""Train a small LM on real text, so the accuracy harness has structured
weights, by the protocol of the repository's `scripts/train_toy.py`.

    python3 -m physics_llm_inference_tpu_torch.bench.train_toy [--steps 600] [--size 14m] [--out checkpoints/toy] [--device cpu]

Random weights make quantization error look benign (per-channel scales
fit N(0, s) by construction); a trained model's do not. The protocol:

- corpus: the Python sources of the interpreter that runs it (its standard
  library first, then its site-packages), up to 8 MB of text, so nothing is
  downloaded (`build_corpus`);
- tokenizer: a byte-level BPE trained on the corpus with the `tokenizers`
  package where it imports, as the script does; elsewhere the corpus's
  UTF-8 bytes (vocab 256). `config.json` records which (`"tokenizer"`);
- model: the `14m` or `140m` GQA shape (head_dim 128, so the fused decode
  kernel takes it), `max_seq_len` 512, f32 parameters from
  `models/transformer.init_params` (seed 0);
- training: batches of `--batch` windows of `--seq` + 1 tokens at starts
  drawn by `np.random.default_rng(0)`; the next-token NLL of the plain f32
  forward (`models/transformer.forward`, no cache: dense attention at seq
  128, under autograd, no kernel); `torch.optim.AdamW` (weight decay 0.01)
  with a `LambdaLR` of optax's `warmup_cosine_decay_schedule(0, lr,
  warmup, steps)`; on the card with TF32 off;
- split: the first 98% of the tokens train, the next at most 200,000 are
  held out.

Outputs under `--out`: `config.json` (the ModelConfig fields and the
tokenizer's kind), `heldout.npy`, `params.npz` (f32, `models/loader.
save_params`' format, which the JAX package's `load_params` reads) and,
with BPE, `tokenizer.json`. One JSON line on stdout (the losses logged
every 25 steps, the seconds, the device); progress on stderr.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
import sysconfig
import time

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.loader import save_params
from ..models.transformer import forward, init_params
from .headline import device_of, log

SHAPES = {
    "14m": dict(hidden_dim=512, num_layers=4, num_heads=4, num_kv_heads=2,
                intermediate_dim=1408),
    # ~143M parameters at vocab 4096
    "140m": dict(hidden_dim=1024, num_layers=12, num_heads=8, num_kv_heads=2,
                 intermediate_dim=2816),
}
MAX_SEQ_LEN = 512
WARMUP = 50            # optax schedule's warmup steps in the script
WEIGHT_DECAY = 0.01
HELDOUT_MAX = 200_000
LOG_EVERY = 25


def build_corpus(max_bytes: int = 8 << 20) -> str:
    """The interpreter's own Python sources, sorted by path, the standard
    library first, until `max_bytes` characters."""
    roots = [os.path.dirname(os.__file__), sysconfig.get_paths()["purelib"]]
    parts, total = [], 0
    for root in roots:
        for path in sorted(glob.glob(os.path.join(root, "**", "*.py"),
                                     recursive=True)):
            try:
                with open(path, encoding="utf-8", errors="ignore") as f:
                    t = f.read()
            except OSError:
                continue
            parts.append(t)
            total += len(t)
            if total >= max_bytes:
                return "\n".join(parts)
    return "\n".join(parts)


def train_tokenizer(corpus: str, vocab_size: int, path: str):
    """The script's byte-level BPE, trained on the corpus, saved to
    `path`."""
    from tokenizers import (Tokenizer, decoders, models, pre_tokenizers,
                            trainers)

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=["<pad>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(
        (corpus[i:i + 65536] for i in range(0, len(corpus), 65536)),
        trainer=trainer)
    tok.save(path)
    return tok


def tokenize(corpus: str, vocab_size: int, out: str,
             use_bpe: bool | None = None) -> tuple[np.ndarray, str, int]:
    """(token ids int32, "bpe" or "bytes", vocab size): BPE where
    `tokenizers` imports (use_bpe None) or when asked, else the UTF-8
    bytes."""
    if use_bpe is None:
        try:
            import tokenizers  # noqa: F401
            use_bpe = True
        except ImportError:
            use_bpe = False
    if use_bpe:
        tok = train_tokenizer(corpus, vocab_size,
                              os.path.join(out, "tokenizer.json"))
        return np.asarray(tok.encode(corpus).ids, dtype=np.int32), "bpe", \
            vocab_size
    ids = np.frombuffer(corpus.encode("utf-8"), dtype=np.uint8)
    return ids.astype(np.int32), "bytes", 256


def split(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The script's 98/2 split, at most HELDOUT_MAX held-out tokens."""
    cut = int(len(ids) * 0.98)
    return ids[:cut], ids[cut:cut + HELDOUT_MAX]


def model_config(size: str, vocab_size: int) -> ModelConfig:
    return ModelConfig(vocab_size=vocab_size, max_seq_len=MAX_SEQ_LEN,
                       dtype="float32", **SHAPES[size])


def schedule(warmup: int, steps: int):
    """The learning-rate multiplier at update `count` (0 first) of optax's
    `warmup_cosine_decay_schedule(0, lr, warmup, steps)` over lr: linear
    from 0 for `warmup` updates, then a cosine to 0 at `steps`."""
    decay = steps - warmup
    if decay <= 0:
        raise ValueError(f"steps ({steps}) must exceed warmup ({warmup})")

    def factor(count: int) -> float:
        if count < warmup:
            return count / warmup
        c = min(count - warmup, decay)
        return 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return factor


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def loss_fn(params, batch: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token NLL of (B, S + 1) windows, log-softmax in f32."""
    logits, _ = forward(params, batch[:, :-1], cfg)
    ll = torch.log_softmax(logits.float(), dim=-1)
    return -ll.gather(-1, batch[:, 1:, None])[..., 0].mean()


def train(params, cfg: ModelConfig, train_ids: np.ndarray, steps: int,
          batch: int = 8, seq: int = 128, lr: float = 3e-4,
          warmup: int = WARMUP, log_every: int = LOG_EVERY) -> list:
    """`steps` AdamW updates of `params` (f32 leaves, trained in place) on
    windows of `train_ids`; returns [(step, loss), ...] at every
    `log_every`-th step and the last, as the script prints them."""
    dev = params["embed"].device
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=WEIGHT_DECAY)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, schedule(warmup, steps))
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.asarray(train_ids, dtype=np.int64))
    losses, t0 = [], time.perf_counter()
    for i in range(steps):
        starts = rng.integers(0, len(train_ids) - seq - 1, batch)
        b = torch.stack([ids[s:s + seq + 1] for s in starts]).to(dev)
        loss = loss_fn(params, b, cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        if i % log_every == 0 or i == steps - 1:
            losses.append((i, float(loss.detach())))
            log(f"step {i:5d}  loss {losses[-1][1]:.4f}  "
                f"({time.perf_counter() - t0:.0f}s)")
    for t in leaves:
        t.requires_grad_(False)
    return losses


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m physics_llm_inference_tpu"
                                 "_torch.bench.train_toy")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=2048,
                    help="BPE vocabulary (bytes: always 256)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default="checkpoints/toy")
    ap.add_argument("--size", default="14m", choices=sorted(SHAPES))
    ap.add_argument("--corpus-bytes", type=int, default=8 << 20)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu to run on the CPU)")
    return ap.parse_args(argv)


def main(argv=None, warmup: int = WARMUP, use_bpe: bool | None = None
         ) -> dict:
    """Run the protocol (`warmup`: the schedule's warmup steps; `use_bpe`:
    None takes BPE where `tokenizers` imports); print and return its
    result."""
    args = parse_args(argv)
    dev = device_of(args.device)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    corpus = build_corpus(args.corpus_bytes)
    ids, kind, vocab = tokenize(corpus, args.vocab, args.out, use_bpe)
    log(f"corpus {len(corpus) / 1e6:.1f} MB text, {len(ids) / 1e6:.2f} M "
        f"tokens ({kind}, vocab {vocab}), {time.perf_counter() - t0:.1f} s")
    train_ids, held = split(ids)
    np.save(os.path.join(args.out, "heldout.npy"), held)
    cfg = model_config(args.size, vocab)
    with open(os.path.join(args.out, "config.json"), "w") as f:
        json.dump(dict(vocab_size=vocab, max_seq_len=MAX_SEQ_LEN,
                       tokenizer=kind, **SHAPES[args.size]), f)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"model {args.size}: {n_params / 1e6:.1f} M params on {dev}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t1 = time.perf_counter()
        losses = train(params, cfg, train_ids, args.steps, args.batch,
                       args.seq, args.lr, warmup)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_s = time.perf_counter() - t1
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    save_params(os.path.join(args.out, "params.npz"), params)
    res = {"metric": "train_toy", "size": args.size, "params": n_params,
           "tokenizer": kind, "vocab_size": vocab, "tokens": int(len(ids)),
           "heldout_tokens": int(len(held)), "steps": args.steps,
           "losses": losses, "train_s": round(train_s, 3),
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"), "out": args.out}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
