#!/usr/bin/env python3
"""Smoke run of the PyTorch port (physics_llm_inference_tpu_torch) on one GPU.

    python3 chip_smoke.py

The phase clock (phase 3b) alone, from the repository's root:

    python3 -c "import torch, chip_smoke as s; s.phase_clock(torch.device('cuda'))"

Parts alone, after phases 1-2 (each tree's package beside the script: a
copy of this script in another tree's root measures that tree):

    python3 chip_smoke.py [--k1] [--attention] [--fused] [--decode] [--serving] [--frontend] [--moe] [--accuracy] [--parallel] [--copy] [--capture] [--train] [--benches] [--determinism {replay,eager,interleave} N]

--k1: phase 3's K1 sweep and K3; --attention: phase 3's K2 (S = 256,
1,024, 4,096), K6 and K7; --fused: K4 in each mode at its seeds, K4's
capture and replay, and K8, with output digests, and the phase clock;
--decode: phase 5's cached_generate at prompt 128 in each K4 mode and on
the per-op path, each against the eager loop; --serving: the
bench_serving7b waves, captured and eager, then one wave under
torch.profiler; --frontend: phase 5c; --moe: phase 3's grouped expert
kernels (moe_experts), then phase 5d; --accuracy:
phase 5e; --parallel: phase 5f; --copy: phase 3's K9-K12; --capture:
part A (captured steps against eager runs, below) with its stress
repeated CAPTURE_REPS times; --train: phase 5g; --benches: phase 5h;
--determinism FORM N: part A's check 2 on K4 W8A16 alone, N launches
replayed, eager or both in turn, each bit-equal to the first.

Phases, each of which raises on failure (exit code != 0, no final line):
1. device: the card's name and power limit (nvidia-smi); no CUDA -> fail;
2. build: nvcc compiles csrc/*.cu into build/, one process per source, all
   in parallel (kernels/_build.py), and each kernel entry's registers and
   spill bytes are logged from ptxas's report;
3. each CUDA kernel (K1 int8_matmul, K2 int8_kv_decode_attention, K3
   lmhead_greedy, K4 fused_decode_step in its modes W8A16, W4A16 and W8A8,
   K5 flash_attention, K6 int8_paged_decode_attention, K7
   paged_decode_attention, K8 fused_paged_decode_step, K9 tiled_matmul, K10
   stream_copy, K11 strided_copy, K12 vector_add, and the grouped expert
   kernels moe_experts, which replace no TPU kernel, at Mixtral-8x7B's
   decode step and config 5's, beside the dequantize-then-bmm products
   they replace) against its plain torch
   version at the main paths' shapes, with the tolerance stated, and both
   timed with CUDA events, beside the kernel's bound at that shape and,
   where one PyTorch call computes the same function, that call's time;
   3b. the phase clock: one clocked launch of each K4 mode at 32 layers
   and of K8 at 32 layers in the engine's geometry, each phase's mean us a
   layer and each GEMM phase's GB/s of weights, then each kernel's
   attention phase with the GB/s of its live KV;
   K2 also at S = 1,024 and 4,096, each with the GB/s of its live KV; K2,
   K6 and K7 each launched twice on the same inputs, bit-equal; K7 also at
   head_dim 120;
   K1 at each 7B linear for M = 64-2047 and the lm_head, on each route,
   beside torch._weight_int8pack_mm and a bf16 torch.mm yardstick;
   K5 also at the paged chunk's shape, GQA groups 1 and 8, head_dim 64 and
   a ragged Sq, with a sweep against SDPA at S = 512-8192 (logged); K9 also
   on a ragged bf16 shape and an N % 8 != 0 one, each through its route's
   launch counter (wgmma + TMA, WMMA, f32); K10, K11 and K12 timed beside
   the library call, and byte-equal at ragged and unaligned shapes; K4 W8A16 and W4A16 under
   check_fused's rules at eight seeds, their x_out errors side by side; K4
   captured once in a CUDA graph and replayed at two write slots, bit-equal
   to eager launches;
4. slice parity: a model at the 7B widths with 2 layers runs prefill plus 8
   teacher-forced decode steps with the kernels and again with the kernels'
   entry points swapped for their plain versions (here, not in the package),
   on the per-op and the fused dense decode paths (the fused one in W8A16,
   W4A16 with INT4 weights and W8A8 with act_quant="int8") and on the paged
   path in the paged engine's default geometry (chunked flash prefill into
   INT8 block pools, fused paged decode); final hidden states or logits and
   greedy tokens are compared;
5. the main paths at full size, on the 7B-class config (32 layers)
   initialized on the card from a seed: cached_generate at batch 64 with 128
   greedy tokens over an INT8 KV cache in the default ModelConfig at prompt
   128 and 512, then on the per-op decode path (K2), then at prompt 128 in
   W4A16 (INT4 block weights) and in W8A8, each of which must launch its K4
   mode once a decode step; each run's decode loop is a CUDA graph captured
   in a warm run and replayed, and its greedy tokens must equal the eager
   loop's (DecodeLoop stepped here, with no graph) on the same weights,
   decode ms a step and tok/s of both logged (the per-op path also the
   host's share of a step); then bench/headline.main(), bench.py's
   protocol, in its default W8A16 configuration (its JSON on a line of its
   own); then the paged serving engine in the scripts/bench_serving7b.py
   configuration (INT8 pools, 512-token blocks, batch 64, horizon 8, radix
   on), its dispatch steps captured by warmup() and at first use, serving
   three waves of 128 requests of prompt 576 (every fourth behind one of 8
   shared 512-token prefixes) for 64 greedy tokens each, which decode
   through K8, each one workload repeated (the radix cache emptied, then
   an unmeasured warm wave, then the same requests), and the same stream
   through the engine with
   eager dispatch functions: tokens, finish reasons and dispatch_trace
   identical, the median wall of each, K1's calls by route and M counted
   over the eager waves; then a profiled wave (the kernels' share of the
   wall); then its per-op routes, INT8 pools at block size 16 (K6) and bf16
   pools (K7). Every kernel of each path must have launched during that
   path's timed run;
   5c. the serving front end on the same weights: the slot InferenceEngine
   (64 slots of 1,024 positions, INT8 pool, horizon 8), captured by
   warmup() on this thread, behind InferenceServer(port=0) with a
   tokenizer that maps each character to its code point: 128 chat requests
   (prompts of 32-576 tokens from a seed, chunked above 512; 64 greedy
   tokens; every fourth over SSE) from 32 client threads, which must launch
   K1 (both routes), K5 and K4 once a decode step and nothing of K2, K3 or
   K8; the same requests from 32 threads straight to the engine, and all
   at once; a full 64-slot horizon's ms a step; then the engine with eager
   dispatch functions (eager_slot_engine_class) on the same requests:
   tokens, finish reasons and dispatch_trace identical to the captured
   engine's, and every HTTP response's tokens equal to its request's
   there; then speculative_k=4 on repetitive prompts, captured and eager
   identical, beside the plain engine (drafts accepted, tokens equal to
   the plain engine's); then the paged engine in the bench_serving7b
   geometry behind the server with no warmup() (its steps captured on the
   serving loop's thread): 64 requests through K8, and abort_request on a
   running request, which must finish "aborted"; then
   `cli serve --config llama7b --int8 --check`;
   5d. the MoE model family at BASELINE config 5's widths
   (scripts/bench_moe.py: hidden 2048, 16 q / 4 kv heads, 8 experts top-2
   of FFN 2816, capacity factor 1.25, INT8 weights and KV), initialized
   on the card from a seed by init_params then quantize_params_int8: a
   2-layer slice parity (prefill plus 8 teacher-forced decode steps with
   the kernels, K1 "stream", K2, K3 and the grouped expert kernels at 10
   slots an expert, and with their plain versions;
   rows whose routing moved are reported, the others held to 2e-2 of
   their own norm, and two controls, one slot less of capacity and
   weights not renormalised, must break that rule); the engines' step
   functions at 2 layers, with the kernels and with the dense and paged
   models' plain entry points, under the same rule: four slot-engine
   prefill chunks of 128 (K1 "wgmma" at K = 2,048; the grouped expert
   kernels at 40 slots), two paged prefill chunks of 16 x 128 (K5; the
   dequantized expert products at 640 slots; each token's final hidden
   state held) and a paged decode step of 32 (K1 "stream", K6, the
   grouped expert kernels), both runs from the kernel
   run's INT8 pools of 16-token blocks; each kernel of both parts held
   against its plain version on the inputs the path gave it; then 16
   layers:
   cached_generate at batch 32, prompt 128, 64 greedy tokens over an INT8
   cache, replayed from a graph and held against the eager loop, beside
   the all-expert and active-expert floors (K1, K2, K3 and the grouped
   expert kernels launched; K4 and K8 not); bench/moe.main([]) and bench/moe.main(["--engine"]), each
   JSON on its own line; the slot engine (32 slots, horizon 8) captured
   and eager on 32 requests, and the paged engine (INT8 pools of 16-token
   blocks: K6, K5) captured and eager: tokens, finish reasons and
   dispatch_trace identical;
   5e. the checkpoint and accuracy path at the CLI's `llama7b` preset
   (LLAMA_7B_CONFIG: 32 layers, 32 q / 32 kv heads, bf16), its weights
   made from a seed on the card: (a) the weights written in HF naming as
   two bf16 safetensors shards (by this script, one tensor at a time) into
   a temporary directory, read back by load_llama with every leaf
   bit-equal, by load_llama(int8=True) bit-equal to quantize_params_int8,
   and by `cli generate --config llama7b --hf DIR --int8` in a
   subprocess, whose text must equal cached_generate's here (and the
   eager loop's tokens); (b) perplexity and decode_path_perplexity over
   64 windows of 256 random tokens on the bf16 weights, within 2% of each
   other, then decode_path_perplexity in W8A16, W4A16 (round to nearest
   and MSE scales) and W8A8 over an INT8 cache, each launching its K4 mode
   once a one-token forward and no other, and quantization_ppl_report;
   (c) every kernel (a) and (b) launched (K1 on both routes, K3, K4 in
   each mode at its 128th decode-path call) held against its plain
   version on the inputs the path gave it; (d) probe_attention_memory's
   flash branch (K5) to 262,144 positions and its naive branch until it
   runs out of device memory, and K5 against its plain version on the
   probe's inputs; (e) the occupancy model for K5's and K7's launches
   from ptxas's registers and shared memory, held to the CUDA runtime's
   count of resident blocks;
   5f. the parallel layer on torch.distributed, a shared-card correctness
   run that measures no scaling (no number of it is a scaling result):
   ranks are spawned processes (torch.distributed.run for the CLI), each
   file-initialized with a PAR_PG_TIMEOUT_S wait; a rank that raises,
   hangs or dies fails the phase. (a) make_mesh(model=1) on nccl in a
   world of one, each collective on device tensors the identity; then
   two ranks sharing the card over gloo (each collective through pinned
   host memory), nccl refused for them: (b) the bench.py 7B GQA model at
   TP 2 (INT8 W+KV; weights from a seed, their digest equal on both
   ranks): prefill at B 8 x 128 and 32 greedy tokens through forward,
   and prefill at 512, against the single process's per-op run on the
   same weights (rank 0): first-step logits within PAR_LOGIT_REL of the
   largest, greedy tokens identical up to the first position where the
   reference's top-two gap is below PAR_MARGIN; the bf16 witness (the
   single process with one weight one ulp away) logged beside it; two
   controls must break the rule (a rank drops its wo all-reduce's sum;
   wqkv sharded without the column permutation); (c) the paged engine at
   TP 2 in the bench_serving7b geometry on 16 requests of prompt 576, 32
   greedy tokens, against the single-process paged engine: dispatch_trace
   identical on both ranks and the reference's, greedy tokens identical
   up to the first near-tie (gaps teacher-forced), and 8 of the requests'
   prompts and reference tokens teacher-forced through the paged model's
   prefill chunk and decode step on the engines' own params: the logits
   at each of the 32 positions within PAR_LOGIT_REL of the reference's
   largest there, the bf16 witness logged beside them; two controls must
   break it (rank 1 drops the wo all-reduce sums of the paged prefill
   chunk, or of the paged decode step); (d)
   `cli serve --tp 2 --dist-backend gloo --config llama7b --int8` under
   torch.distributed.run, four chat requests to rank 0, each answer's
   tokens identical to the single-process slot engine's on the same seed
   up to the first near-tie (the HTTP answer carries no logits; the slot
   engine's steps run `forward`, held by logits in (b)); (e) moe_layer_ep
   over 2 ranks at config
   5's MoE widths (4,096 tokens, INT8 stacks, capacity 1.25) against
   moe_layer on each rank's slice; (f) ring attention over 2 ranks (B 1,
   32 q / 8 kv heads of 128, S 8,192) against K5 over the whole sequence
   and its plain version; (g) K1 (both routes), K2, K5 and K6 launched
   by (b) and (c) on each rank (counted around the timed runs only) and
   held against their plain versions on the ranks' own inputs. Each
   part's seconds, each rank's ms a decode step and its share in
   collectives are logged;
   A. (after phase 5's paged engine, on its 7B weights) captured steps
   against eager runs: (1) two captured steps of one owner, A then B,
   replayed B, A, B, A: B's static output must stay an eager B's (a raw
   pair of graphs sharing one pool is the control that shows the
   hazard); (2) every kernel of phase 5's captured paths and the library
   GEMM of prefill linears captured, then replays and eager launches
   interleaved on fixed inputs, each bit-equal to the first eager launch
   (kernel_determinism); (3)
   cached_generate's captured decode loop and the same loop stepped
   eagerly, in lockstep at prompt 128 and 512: the prefills, then each
   step's tokens and written cache slot; the paged engine captured and
   eager, stepped in turn on the bench_serving7b stream: each step's
   tokens, dispatches and pools but the trash block; (4) the stress:
   full_run at prompt 128 and 512 with (3)'s lockstep, and the paged
   engine's captured wave against its eager one, FULL_RUN_CAPTURE's
   repetitions (--capture: CAPTURE_REPS). Every check logs before the
   part fails;
   5g. a checkpoint trained on the card: bench/train_toy trains 14m for
   600 steps in a temporary directory (the mean of its last 25 logged
   losses TRAIN_LOSS_MARGIN below its first); bench/accuracy on it (its
   INT8 budget stands; K4 launched in W8A16 and W4A16); W8A8's
   decode-path perplexity (K4 W8A8 once a one-token forward), one of its
   launches held to W8A8's rule two layers at a time with phase 3's
   controls' catches reported; the slot engine with speculative_k 4
   against 0 on held-out prompts (accepted tokens a dispatch, requests
   whose tokens equal the plain engine's);
   5h. bench/serving7b, bench/speculative, bench/attribution,
   bench/probe_step_overhead and bench/probe_prefill at their defaults,
   each JSON on its own line, each launching its kernels (BENCHES) and
   its result held by bench_check; utils/profiling's dispatch_overhead
   and fusion_benefit. After phase 5e the process may hold at most 2 GiB
   reserved above what it has allocated (device_memory_stats). Each
   phase's seconds are logged;
6. the kernel microbenchmark path at the JAX package's default sizes, through
   its public functions: bench_gemm with K9 and with torch.matmul (4096^3
   bf16), bench_gemv (8 x 4096 x 4096, bf16 and K1 int8), bench_attention
   (seq 2048, K5 and the grouped SDPA), bench_precision,
   measure_access_patterns (K10, K11), vector_add (K12), then
   bench.suite.main in full. K9-K12, K1 and K5 must have launched, the
   suite must give the JAX suite's keys, and no roofline_fraction may
   exceed 1.05.
Then one JSON line with each kernel's numbers (launches summed over the
timed runs of phases 5, 5c, 5d, 5e, 5f (both ranks), 5g, 5h and 6; of
5d's bench/moe.main calls and 5h's benches, each whole call, its warm
runs and captures included), and the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "physics_llm_inference_tpu_torch"

# 7B-class GQA model of bench.py (hidden 4096, 32 layers, 32q/8kv, FFN 11008)
WIDTHS = dict(vocab_size=32000, hidden_dim=4096, num_heads=32,
              num_kv_heads=8, intermediate_dim=11008, max_seq_len=2048,
              dtype="bfloat16")
BATCH, PROMPT, LONG_PROMPT, NEW_TOKENS = 64, 128, 512, 128
SEED = 0
# the paged engine of scripts/bench_serving7b.py
SERVE_REQUESTS, SERVE_PROMPT, SERVE_TOKENS, SHARED_PREFIXES = 128, 576, 64, 8
KERNELS = {  # name: (module, launch counter, CUDA source, TPU kernel replaced)
    # K1's two routes: the weight stream (decode rows) and wgmma (prefill
    # rows), each its own kernel and launch counter
    "int8_matmul": ("int8_matmul", "stream_launches", "csrc/int8_matmul.cu",
                    "physics_llm_inference_tpu/kernels/int8_matmul.py:52"),
    "int8_matmul_prefill": (
        "int8_matmul", "wgmma_launches", "csrc/int8_matmul.cu",
        "physics_llm_inference_tpu/kernels/int8_matmul.py:52"),
    "int8_kv_decode_attention": (
        "int8_kv_attention", "launches", "csrc/int8_kv_attention.cu",
        "physics_llm_inference_tpu/kernels/int8_kv_attention.py:148"),
    "lmhead_greedy": ("lmhead", "launches", "csrc/lmhead.cu",
                      "physics_llm_inference_tpu/kernels/lmhead.py:92"),
    "fused_decode_step": (
        "fused_decode", "launches", "csrc/fused_decode.cu",
        "physics_llm_inference_tpu/kernels/fused_decode.py:1200"),
    # the same TPU kernel's other two bodies, each its own template instance
    # and launch counter
    "fused_decode_step_w4a16": (
        "fused_decode", "w4a16_launches", "csrc/fused_decode.cu",
        "physics_llm_inference_tpu/kernels/fused_decode.py:1200"),
    "fused_decode_step_w8a8": (
        "fused_decode", "w8a8_launches", "csrc/fused_decode.cu",
        "physics_llm_inference_tpu/kernels/fused_decode.py:1200"),
    "flash_attention": (
        "flash_attention", "launches", "csrc/flash_attention.cu",
        "physics_llm_inference_tpu/kernels/flash_attention.py:310"),
    "int8_paged_decode_attention": (
        "paged_attention", "int8_paged_launches", "csrc/paged_attention.cu",
        "physics_llm_inference_tpu/kernels/paged_attention.py:223"),
    "paged_decode_attention": (
        "paged_attention", "paged_launches", "csrc/paged_attention.cu",
        "physics_llm_inference_tpu/kernels/paged_attention.py:81"),
    "fused_paged_decode_step": (
        "fused_decode", "paged_launches", "csrc/fused_decode.cu",
        "physics_llm_inference_tpu/kernels/fused_decode.py:1002"),
    "tiled_matmul": ("matmul", "launches", "csrc/tiled_matmul.cu",
                     "physics_llm_inference_tpu/kernels/matmul.py:42"),
    "stream_copy": ("membench", "stream_launches", "csrc/membench.cu",
                    "physics_llm_inference_tpu/kernels/membench.py:29"),
    "strided_copy": ("membench", "strided_launches", "csrc/membench.cu",
                     "physics_llm_inference_tpu/kernels/membench.py:44"),
    "vector_add": ("hello_pallas", "launches", "csrc/vector_add.cu",
                   "physics_llm_inference_tpu/kernels/hello_pallas.py:23"),
    # no TPU kernel: the JAX package's expert products are einsums outside
    # Pallas; this one replaces the port's dequantize-then-bmm products
    "moe_experts": ("moe_experts", "launches", "csrc/moe_experts.cu",
                    "none (physics_llm_inference_tpu/models/moe.py:122, "
                    "XLA einsums)"),
}
# K4's modes: the block weights' init, cfg.act_quant, the KERNELS entry
# whose counter the mode's launches go to, the weight bits of the HBM floor
FUSED_MODES = {"w8a16": ("init_params_int8", "none", "fused_decode_step", 8),
               "w4a16": ("init_params_int4", "none",
                         "fused_decode_step_w4a16", 4),
               "w8a8": ("init_params_int8", "int8",
                        "fused_decode_step_w8a8", 8)}
# the microbenchmark path (phase 6) must launch these
MICRO_KERNELS = ("tiled_matmul", "stream_copy", "strided_copy", "vector_add",
                 "int8_matmul", "flash_attention")


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def ptxas_report(logs: dict) -> list:
    """One line a source from nvcc's -Xptxas -v report: each kernel entry's
    registers and spill bytes (stores/loads)."""
    import re
    import shutil

    lines = []
    for src, text in sorted(logs.items()):
        entries, props, cur = {}, None, None
        for ln in text.splitlines():
            if m := re.search(r"Compiling entry function '(\w+)'", ln):
                cur = m.group(1)
                entries[cur] = [None, None, None]
            elif m := re.search(r"Function properties for (\w+)", ln):
                props = m.group(1)
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                                r"loads", ln):
                if props in entries:
                    entries[props][1:] = [int(m.group(1)), int(m.group(2))]
            elif (m := re.search(r"Used (\d+) registers", ln)) and cur:
                entries[cur][0] = int(m.group(1))
        names = list(entries)
        filt = shutil.which("c++filt") or shutil.which("cu++filt")
        if filt and names:
            out = subprocess.run([filt], input="\n".join(names), text=True,
                                 capture_output=True).stdout.splitlines()
            if len(out) == len(names):
                strip = r"^void |\(anonymous namespace\)::|\(.*\)$"
                names = [re.sub(strip, "", n) for n in out]
        parts = [f"{n} {r} registers, spill {st}/{ld} bytes"
                 for n, (r, st, ld) in zip(names, entries.values())]
        lines.append(f"ptxas {src}: " + "; ".join(parts))
    return lines


def time_ms(fn, flush, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` launches, each timed with CUDA
    events after a write of `flush` (larger than the 50 MB L2) so every
    launch finds its weights cold, as the decode loop does. A ~1 ms device
    spin before the start event keeps the card busy while the host enqueues
    fn(), so the host's launch overhead stays out of the reading."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bf16_ulp(v):
    import torch

    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


def kernel_module(name):
    import importlib

    return importlib.import_module(f"{PKG}.kernels.{KERNELS[name][0]}")


def reset_launches():
    for name in KERNELS:
        setattr(kernel_module(name), KERNELS[name][1], 0)


def read_launches() -> dict:
    return {name: getattr(kernel_module(name), KERNELS[name][1])
            for name in KERNELS}


def digest(*ts) -> str:
    """The first 16 hex digits of a sha256 over the tensors' bytes: two
    trees' kernels on the same inputs are bit-equal where these agree."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def rows_rel(a, b):
    """Each row's relative error ||a - b|| / ||b||."""
    return (a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)


def row_rel(a, b) -> float:
    """Row-wise relative error, the worst row."""
    return float(rows_rel(a, b).max())


def entry(err, ms, pms, nbytes, flops, peak="bf16", library_ms=None) -> dict:
    """A kernel's row: its numbers, and its bound at the row's shape: the
    larger of the bytes it must move (each input read once, each output
    written once) over the H100 SXM's 3.35 TB/s and its operations over the
    data-sheet peak of their type (bf16 989 TFLOP/s, int8 1,979 TOP/s, f32
    67). `flops` is a count of `peak`'s type, or {type: count}."""
    from physics_llm_inference_tpu_torch.specs.gpu import H100_SXM as spec

    t_bytes = nbytes / spec.hbm_bandwidth * 1e3
    rate = {"bf16": spec.peak_flops, "int8": spec.peak_int8_ops,
            "fp32": spec.fp32_tflops * 1e12}
    ops = flops if isinstance(flops, dict) else {peak: flops}
    t_ops = sum(n / rate[kind] for kind, n in ops.items()) * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def int8pack_ms(x, wq, s, want, flush, reps: int = 20):
    """Time of torch._weight_int8pack_mm (x @ w.T * scales, w (N, K) int8)
    on the same function, or None where the installed torch does not run it
    on CUDA or it disagrees with the plain version."""
    import torch

    wt, sc = wq.t().contiguous(), s.reshape(-1).to(x.dtype)
    try:
        got = torch._weight_int8pack_mm(x, wt, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        log(f"torch._weight_int8pack_mm not run on CUDA: "
            f"{str(e).splitlines()[0][:120]}")
        return None
    rel = row_rel(got.float(), want)
    if rel > 2e-2:
        log(f"torch._weight_int8pack_mm disagrees (row-wise {rel:.3g})")
        return None
    return time_ms(lambda: torch._weight_int8pack_mm(x, wt, sc), flush, reps,
                   warmup=1)


# K1's shapes: the 7B block linears (K, N) at the rows the main paths give
# them: M = 64, a decode step's batch, then the serving engine's prefill
# dispatches (R chunks of up to 512 tokens, R a power of two) below the
# 2,048 rows from which models/transformer._linear takes a library GEMM
K1_ROWS = (64, 128, 256, 512, 1024, 2047)


def k1_linears() -> dict:
    d, f = WIDTHS["hidden_dim"], WIDTHS["intermediate_dim"]
    hd = d // WIDTHS["num_heads"]
    return {"wqkv": (d, (WIDTHS["num_heads"] + 2 * WIDTHS["num_kv_heads"])
                     * hd), "wo": (d, d), "w_gate_up": (d, 2 * f),
            "w_down": (f, d)}


def k1_case(km, x, wq, s, route, what: str):
    """One K1 launch on `route` against the plain version: rtol 1e-2
    (another f32 summation order, then one bf16 round) plus 1e-3 of the
    output's max (entries that cancel to ~0); a second launch must give the
    same bits (fixed-order sums), and the entry point too where the rule
    picks `route`. Returns (max abs err, the plain output)."""
    import torch

    got = km._launch(route, x, wq[1], s[1])
    again = km._launch(route, x, wq[1], s[1])
    want = km.int8_matmul_plain(x, wq, s, layer=1).float()
    m, k = x.shape
    entry_point = (km.int8_matmul(x, wq, s, layer=1)
                   if km.pick_route(m, wq.shape[-1], k) == route else got)
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    bound = 1e-2 * want.abs() + 1e-3 * float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(f"K1 {what}: max err {float(err.max()):.4g} "
                             "exceeds rtol 1e-2 + 1e-3 of the max")
    if not (torch.equal(got, again) and torch.equal(got, entry_point)):
        raise AssertionError(f"K1 {what}: two launches differ")
    return float(err.max()), want


def check_k1(dev, flush, g) -> dict:
    """K1 at every (linear, M) of K1_ROWS and the lm_head at M = 64 (plus a
    ragged M), on each route the wrapper has (each checked, bit-equal twice,
    timed), beside the bound, torch._weight_int8pack_mm (the library call
    computing the same function) and, from M = 128, torch.mm of x with the
    weights cast to bf16 (f32 output: what _linear_f32 runs from 2,048
    rows; a GEMM-only yardstick, never called by the port for K1). Returns
    the entries of the four linears at M = 64 (int8_matmul) and of gate/up
    at M = 512 (int8_matmul_prefill)."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import int8_matmul as km
    from physics_llm_inference_tpu_torch.kernels.w8a16_stream import plan

    out, layer64 = {}, {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bytes": 0,
                        "flops": 0, "err": 0.0}
    shapes = [(name, m, k, n) for m in K1_ROWS
              for name, (k, n) in k1_linears().items()]
    shapes.insert(4, ("lm_head", 64, WIDTHS["hidden_dim"],
                      WIDTHS["vocab_size"]))
    shapes.insert(5, ("ragged", 7, WIDTHS["hidden_dim"],
                      k1_linears()["wqkv"][1] + 64))
    per_m = {}
    for name, m, k, n in shapes:
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        wq = torch.randint(-127, 128, (2, k, n), dtype=torch.int8,
                           generator=g, device=dev)
        s = torch.rand((2, 1, n), generator=g, device=dev) * 2 / (73.9 * k ** 0.5)
        wbytes = nbytes(x, wq[1], s[1]) + m * n * 2
        flops = 2 * m * k * n
        bound = entry(0.0, 0.0, 0.0, wbytes, flops)
        parts, times, err = [], {}, 0.0
        for r in km.ROUTES:
            e, want = k1_case(km, x, wq, s, r, f"{name} ({m},{k},{n}) {r}")
            err = max(err, e)
            ms = time_ms(lambda: km._launch(r, x, wq[1], s[1]), flush)
            times[r] = ms
            stage = ""
            if r == "stream":   # the ring's us a stage on one SM
                pl = plan(m, n, k, km.num_sms(dev))
                stage = f", {ms * 1e3 * pl.blocks / pl.tiles:.2f} us a stage"
            parts.append(f"{r} {ms:.4f} ms ({flops / ms / 1e9:.1f}"
                         f" TFLOP/s, {k * n / ms / 1e6:.0f} GB/s of weights"
                         f"{stage})")
        chosen = km.pick_route(m, n, k)
        ms = times[chosen]
        lib = int8pack_ms(x, wq[1], s[1], want, flush, reps=5)
        mm = None
        if m >= 128:
            wb = wq[1].bfloat16()
            mm = time_ms(lambda: torch.mm(x, wb, out_dtype=torch.float32),
                         flush)
            del wb
        log(f"K1 {name:9s} M={m} K={k} N={n}: {'; '.join(parts)}"
            f", rule -> {chosen}; max_abs_err "
            f"{err:.4g}; bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']}); torch._weight_int8pack_mm "
            f"{'none' if lib is None else f'{lib:.4f} ms'}"
            + ("" if mm is None else f"; torch.mm bf16 (f32 out) {mm:.4f} ms "
               f"({flops / mm / 1e9:.1f} TFLOP/s)"))
        if name in k1_linears():
            acc = per_m.setdefault(m, {"ms": 0.0, "bound": 0.0, "lib": 0.0,
                                       "mm": 0.0,
                                       **{r: 0.0 for r in km.ROUTES}})
            acc["ms"] += ms
            acc["bound"] += bound["bound_ms"]
            acc["lib"] = None if lib is None or acc["lib"] is None \
                else acc["lib"] + lib
            acc["mm"] += mm or 0.0
            for r in km.ROUTES:
                acc[r] += times[r]
        if m == 64 and name in k1_linears():
            layer64["ms"] += ms
            layer64["plain"] += time_ms(
                lambda: km.int8_matmul_plain(x, wq, s, layer=1), flush)
            layer64["lib"] = None if lib is None or layer64["lib"] is None \
                else layer64["lib"] + lib
            layer64["bytes"] += wbytes
            layer64["flops"] += flops
            layer64["err"] = max(layer64["err"], err)
        if m == 512 and name == "w_gate_up":
            out["int8_matmul_prefill"] = entry(
                err, ms, time_ms(lambda: km.int8_matmul_plain(
                    x, wq, s, layer=1), flush, reps=5), wbytes, flops,
                library_ms=lib)
        del x, wq, s, want
    for m, acc in per_m.items():
        lib = acc["lib"]
        log(f"K1 the four linears at M={m}: kernel {acc['ms']:.4f} ms"
            + "".join(f", {r} {acc[r]:.4f}" for r in km.ROUTES)
            + f"; bound {acc['bound']:.4f} ms; torch._weight_int8pack_mm "
            f"{'none' if lib is None else f'{lib:.4f} ms'}"
            + (f"; torch.mm bf16 {acc['mm']:.4f} ms" if m >= 128 else ""))
    torch.cuda.empty_cache()
    return {"int8_matmul": entry(layer64["err"], layer64["ms"],
                                 layer64["plain"], layer64["bytes"],
                                 layer64["flops"], library_ms=layer64["lib"]),
            **out}


def check_kernels(dev, flush) -> dict:
    """Phase 3. Returns {kernel: entry}."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    out.update(check_k1(dev, flush, g))

    out["int8_kv_decode_attention"] = check_k2(dev, flush, g)
    out["lmhead_greedy"] = check_k3(dev, flush, g)
    for mode, (_, _, name, _) in FUSED_MODES.items():
        out[name] = check_fused(dev, flush, mode)[0]
    fused_seeds(dev, flush)
    check_fused_capture(dev)
    out["flash_attention"] = check_flash(dev, flush)
    out.update(check_paged_attention(dev, flush))
    out["fused_paged_decode_step"] = check_fused_paged(dev, flush)
    out["moe_experts"] = check_moe_experts(dev, flush)
    out.update(check_teaching(dev, flush))
    return out


# the grouped expert kernels' shapes (E, C, D, F): Mixtral-8x7B's decode
# step (the benchmark's mixtral8x7b.decode: 64 tokens, top-2 of 8 experts
# at capacity factor 4.0) and phase 5d's (config 5, B 32 at 1.25)
MOE_KERNEL_SHAPES = {"mixtral": (8, 64, 4096, 14336),
                     "config 5": (8, 10, 2048, 2816)}


def check_moe_experts(dev, flush) -> dict:
    """The grouped expert kernels (kernels/moe_experts) at
    MOE_KERNEL_SHAPES, the last expert's second half of slots empty: held
    against the plain version by K1's rule (rtol 1e-2 plus 1e-3 of the
    output's max), two calls bit-equal, two launches a call; timed with
    each launch apart, beside their bound (the three stacks' int8 weights
    and f32 scales and the slots read once, the output written once, over
    3.35 TB/s), the plain version and the path they replace (each stack
    dequantized to bf16, three torch.bmm, silu and a product). Returns the
    Mixtral row."""
    import torch
    import torch.nn.functional as F

    from physics_llm_inference_tpu_torch.kernels import moe_experts as me
    from physics_llm_inference_tpu_torch.models.quant import QuantizedTensor

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    rows = {}
    for name, (e, c, d, f) in MOE_KERNEL_SHAPES.items():
        def stack(k, n):
            q = torch.randint(-127, 128, (e, k, n), dtype=torch.int8,
                              generator=g, device=dev)
            s = (torch.rand((e, 1, n), generator=g, device=dev) + 0.5) \
                / (73.3 * k ** 0.5)
            return QuantizedTensor(q, s)

        w1, w3, w2 = stack(d, f), stack(d, f), stack(f, d)
        x = torch.randn((e, c, d), generator=g, device=dev).bfloat16()
        x[e - 1, c // 2:] = 0
        what = f"moe_experts {name} (E {e}, C {c}, D {d}, F {f})"
        before = me.launches
        got = me.moe_experts(x, w1, w3, w2)
        torch.cuda.synchronize()
        if me.launches != before + 2:
            raise AssertionError(f"{what}: {me.launches - before} launches "
                                 "counted, not 2")
        want = me.moe_experts_plain(x, w1, w3, w2).float()
        diff = (got.float() - want).abs()
        lim = 1e-2 * want.abs() + 1e-3 * float(want.abs().max())
        if not bool(torch.isfinite(got).all()) or bool((diff > lim).any()):
            raise AssertionError(f"{what}: off its plain version, max abs "
                                 f"err {float(diff.max()):.4g}")
        if not torch.equal(me.moe_experts(x, w1, w3, w2), got):
            raise AssertionError(f"{what}: two calls differ")

        def dequantized():
            a, b, o = (w.dequantize(torch.bfloat16) for w in (w1, w3, w2))
            return torch.bmm(F.silu(torch.bmm(x, a)) * torch.bmm(x, b), o)

        hidden = torch.empty((e, c, f), dtype=torch.bfloat16, device=dev)
        ms = time_ms(lambda: me.moe_experts(x, w1, w3, w2), flush)
        ms_a = time_ms(lambda: me._stream(x, (w1, w3), hidden), flush)
        ms_b = time_ms(lambda: me._stream(hidden, (w2,), got), flush)
        pms = time_ms(lambda: me.moe_experts_plain(x, w1, w3, w2), flush,
                      reps=5)
        lib = time_ms(dequantized, flush, reps=5)
        wbytes = nbytes(*w1, *w3, *w2)
        row = entry(float(diff.max()), ms, pms, wbytes + nbytes(x, got),
                    6 * e * c * d * f, library_ms=lib)
        log(f"{what} ({nvidia_smi()}): kernel {ms:.4f} ms "
            f"({wbytes / ms / 1e6:.0f} GB/s of weights; gate/up launch "
            f"{ms_a:.4f} ms, down "
            f"{ms_b:.4f} ms), plain {pms:.4f} ms, dequantize + bmm "
            f"{lib:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}); max abs err {float(diff.max()):.4g}; two "
            f"calls bit-equal")
        rows[name] = row
        del w1, w3, w2, x, got, want, diff, lim, hidden
        torch.cuda.empty_cache()
    return rows["mixtral"]


def check_k2(dev, flush, g) -> dict:
    """K2 at B = 64, Hq 32, Hkv 8, d 128 over a 2-layer cache with ragged
    ranges (q_slot in [S/2, S), valid_from in [0, S/2)), at S = 256 (the
    per-op path's cache: prompt 128 + 128 tokens), 1,024 and 4,096: held
    against its plain version, two launches bit-equal, timed with the GB/s
    of live KV. Returns the entry at S = 256."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import int8_kv_attention as ka

    hq, hkv = WIDTHS["num_heads"], WIDTHS["num_kv_heads"]
    hd = WIDTHS["hidden_dim"] // hq
    L, B = 2, 64
    g_long = torch.Generator(device=dev).manual_seed(SEED + 10)
    for S in (256, 1024, 4096):
        gen = g if S == 256 else g_long   # S = 256 draws what it always drew
        q = torch.randn((B, hq, hd), generator=gen, device=dev).bfloat16()
        kq, vq = (torch.randint(-127, 128, (L, B, S, hkv * hd),
                                dtype=torch.int8, generator=gen, device=dev)
                  for _ in "kv")
        ks, vs = (torch.rand((L, B, hkv, S), generator=gen, device=dev) * 0.03
                  for _ in "kv")
        qslot = torch.randint(S // 2, S, (B,), generator=gen, device=dev).int()
        vfrom = torch.randint(0, S // 2, (B,), generator=gen, device=dev).int()
        args = (q, kq, ks, vq, vs, qslot, vfrom)
        got = ka.int8_kv_decode_attention(*args, layer=1).float()
        want = ka.int8_kv_decode_attention_plain(*args, layer=1).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not bool(torch.isfinite(got).all()) or err > 2e-2:
            raise AssertionError(f"K2 S={S}: max abs err {err:.4g} > 2e-2")
        if not torch.equal(ka.int8_kv_decode_attention(*args, layer=1).float(),
                           got):
            raise AssertionError(f"K2 S={S}: two launches differ")
        ms = time_ms(lambda: ka.int8_kv_decode_attention(*args, layer=1),
                     flush)
        pms = time_ms(lambda: ka.int8_kv_decode_attention_plain(
            *args, layer=1), flush, reps=5 if S > 256 else 20)
        keys = int((qslot - vfrom + 1).sum())  # live keys, one layer
        live = keys * hkv * hd * 2
        log(f"K2 int8_kv_decode_attention B={B} S={S} Hq={hq} Hkv={hkv} "
            f"d={hd}: max_abs_err {err:.4g} (atol 2e-2), two launches "
            f"bit-equal, kernel {ms:.4f} ms ({live / ms / 1e6:.0f} GB/s of "
            f"live KV), plain {pms:.4f} ms")
        if S == 256:
            row = entry(err, ms, pms, keys * hkv * (2 * hd + 2 * 4)
                        + 2 * nbytes(q) + nbytes(qslot, vfrom),
                        4 * hq * hd * keys)
        del kq, vq, ks, vs
    return row


def check_k3(dev, flush, g) -> dict:
    """K3 at B=64, D=4096, V=32000 against the plain version, timed; returns
    its entry."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import int8_matmul as km
    from physics_llm_inference_tpu_torch.kernels import lmhead as kh
    from physics_llm_inference_tpu_torch.ops.norms import rms_norm

    d, v = WIDTHS["hidden_dim"], WIDTHS["vocab_size"]
    # K3 at B=64, D=4096, V=32000: the kernel's token must carry a plain
    # logit within one bf16 ulp of the plain row maximum
    x = torch.randn((64, d), generator=g, device=dev).bfloat16()
    nw = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).bfloat16()
    lq = torch.randint(-127, 128, (d, v), dtype=torch.int8, generator=g,
                       device=dev)
    ls = torch.rand((1, v), generator=g, device=dev) * 2 / (73.9 * d ** 0.5)
    tok = kh.lmhead_greedy(x, nw, lq, ls, eps=1e-6).long()
    ptok = kh.lmhead_greedy_plain(x, nw, lq, ls, eps=1e-6).long()
    logits = km.int8_matmul_plain(rms_norm(x, nw, 1e-6), lq, ls,
                                  out_dtype=torch.float32)
    logits = logits.bfloat16().float()
    top = logits.max(dim=-1).values
    gap = top - logits.gather(1, tok[:, None])[:, 0]
    if bool((gap > bf16_ulp(top)).any()):
        raise AssertionError(f"K3: token logit {float(gap.max()):.4g} below "
                             "the row max, more than one bf16 ulp")
    err = float(gap.max())
    ms = time_ms(lambda: kh.lmhead_greedy(x, nw, lq, ls, eps=1e-6), flush)
    pms = time_ms(lambda: kh.lmhead_greedy_plain(x, nw, lq, ls, eps=1e-6),
                  flush)
    same = int((tok == ptok).sum())
    log(f"K3 lmhead_greedy B=64 D={d} V={v}: {same}/64 tokens equal to plain, "
        f"max gap to the row max {err:.4g} (<= 1 bf16 ulp), kernel "
        f"{ms:.4f} ms ({d * v / ms / 1e6:.0f} GB/s of head), plain {pms:.4f} ms")
    return entry(err, ms, pms, nbytes(x, nw, lq, ls, tok.int()),
                 2 * 64 * d * v)


def fused_bound(blocks, x, L, hkv, hd, hq, read_keys, written,
                act_quant="none"):
    """(bytes, {type: operations}) of one fused decode step: every weight
    (INT4: the packed codes), scale (INT4: the group scales) and norm once,
    the live K/V codes and scales read, the new ones written, x in and out.
    The block matmuls count K·N multiply-adds a row whatever the packing,
    in int8 under W8A8 and bf16 otherwise; attention is bf16."""
    from physics_llm_inference_tpu_torch.models.quant import QuantizedTensor4

    wts = [blocks[n] for n in ("wqkv", "wo", "w_gate_up", "w_down")]
    weights = sum(nbytes(w.q, w.s) for w in wts) + nbytes(blocks["ln1"],
                                                          blocks["ln2"])
    per_key = L * hkv * (2 * hd + 2 * 4)
    macs = sum(w.q[0].numel() * (2 if isinstance(w, QuantizedTensor4) else 1)
               for w in wts)
    matmul = 2 * x.shape[0] * macs * L
    attn = 4 * hq * hd * L * (read_keys + written)
    ops = ({"int8": matmul, "bf16": attn} if act_quant == "int8"
           else {"bf16": matmul + attn})
    return weights + per_key * (read_keys + written) + 2 * nbytes(x), ops


# W8A8's rules for a row-wise comparison of the kernel with the plain
# version, each a (median row, worst row) limit on rows_rel. The kernel's
# attention (an online softmax over key tiles) and the plain version's (one
# softmax over all keys) round p * v_scale to bf16 apart. A bf16 attention
# value that rounds apart can flip its int8 activation code, and a flipped
# row maximum moves every code of its row, so single rows move by a few
# percent: W8A8_TILED. Where no cached key is live, attention is the current
# token's V in both versions, every product is exact in int32 and the norms
# are correctly rounded, so most rows agree to the last bits; a code that
# rounds apart at a near-tie in layer 0 still moves its row by up to ~1%
# through layer 1's quantizers: W8A8_OWN_TOKEN. Each rule is checked against
# controls, the plain version with one of its four activation quantization
# points left out, which a sound rule must refuse.
W8A8_TILED, W8A8_OWN_TOKEN = (2e-2, 1e-1), (1e-4, 2e-2)
QUANT_POINTS = ("ln1", "attention", "ln2", "silu")


def w8a8_rows_ok(rel, controls: dict, what: str, rule=W8A8_TILED) -> str:
    """Hold `rel` (rows_rel of the kernel against the plain version) to
    `rule`, and every control ({point: rows_rel of the plain version
    without that quantization point, against the same plain run}) to
    failing it. Returns the readings."""
    said = f"median <= {rule[0]:g}, worst <= {rule[1]:g}"

    def reading(r):
        return f"median {float(r.median()):.4g}, worst {float(r.max()):.4g}"

    if not w8a8_passes(rel, rule):
        raise AssertionError(f"{what}: {reading(rel)}, outside {said}")
    for point, r in controls.items():
        if w8a8_passes(r, rule):
            raise AssertionError(
                f"{what}: the control without the {point} quantization "
                f"passes {said} too ({reading(r)}): the rule cannot tell a "
                "kernel that skips it")
    return (f"{reading(rel)} ({said}); controls without a quantization "
            "point: " + ", ".join(f"{p} {reading(r)}"
                                  for p, r in controls.items()))


def w8a8_passes(r, rule=W8A8_TILED) -> bool:
    """Whether rows_rel `r` keeps within a W8A8 (median, worst) rule."""
    import torch

    return (bool(torch.isfinite(r).all()) and float(r.median()) <= rule[0]
            and float(r.max()) <= rule[1])


class quant_point_off:
    """The plain fused step with one W8A8 activation quantization point
    (QUANT_POINTS) left out: that point's f32 row goes into its product
    unquantized. fused_decode_step_plain quantizes, in each layer, the ln1
    row, k, v, the attention row, the ln2 row and the silu row, in that
    order; a run that makes another number of calls raises."""

    def __init__(self, point: str, layers: int):
        self.at = {"ln1": 0, "attention": 3, "ln2": 4, "silu": 5}[point]
        self.layers = layers
        self.kf = kernel_module("fused_decode_step")

    def __enter__(self):
        import torch

        quant = self.quant = self.kf._quant
        self.calls = 0

        def off(t):
            at, self.calls = self.calls % 6, self.calls + 1
            if at == self.at:
                return t.float(), torch.ones_like(t[..., :1], dtype=torch.float32)
            return quant(t)

        self.kf._quant = off

    def __exit__(self, *exc):
        self.kf._quant = self.quant
        if exc[0] is None and self.calls != 6 * self.layers:
            raise AssertionError(f"quant_point_off: {self.calls} quantizer "
                                 f"calls, expected {6 * self.layers}")


def w8a8_controls(run, want, layers: int) -> dict:
    """{point: rows_rel(run() without that quantization point, want)}."""
    out = {}
    for point in QUANT_POINTS:
        with quant_point_off(point, layers):
            out[point] = rows_rel(run(), want)
    return out


# K4 W4A16's rule. Its random INT4 weights (uniform nibbles, mean -0.5)
# make the residual stream large and uneven: at 2 layers the median x_out
# row norm is ~3.7e4 (~60 in W8A16), and a few rows cancel to 30-500x below
# it, which multiplies their error relative to their own norm. The kernel's
# layer-0 K/V codes equal the plain version's, and with no cached key live
# the two agree within ~0.2% over two layers; it departs where its tiled
# softmax rounds p * v_scale to bf16 against another running max than the
# plain one-pass softmax. Two bf16 roundings of one value at two scales
# differ by up to one ulp, twice the half ulp between one rounding and the
# value itself; to first order a row's x_out moves linearly with those
# per-element differences, so its expected move is at most twice the move
# of the plain version with p * v_scale left unrounded (the reference's
# spread at the point where the kernel departs). Both are taken at the same
# row relative to its own norm, so the row's cancellation multiplies both
# alike. Each row's error relative to its own norm is held to the larger
# of 2e-2 and twice that row's spread. A fixed 2e-2 of the row's own norm
# failed at random seeds (0.11, 0.73, 0.21 at seeds 102, 302, 402) where the
# spread was as large. Each control, the plain version with a defect a W4A16
# kernel could have, must break the rule on some row: three gross ones
# (nibble order, Q rotation, the first live key left out) and two single
# bf16 roundings the plain version does not make (the cached keys' q . k,
# and the P @ V sum over them before the division).
W4A16_RULE = 2e-2
W4A16_CONTROLS = ("nibble order", "Q rotation", "first key", "bf16 q.k",
                  "bf16 P@V")


class w4a16_variant:
    """The plain fused step changed at one point: "unrounded p*v" keeps
    p * v_scale in f32 (the spread of W4A16's rule); the defects "nibble
    order" (each packed byte's high nibble read as the low one's channel
    and the low as the high one's), "Q rotation" (the queries left
    unrotated; fused_decode_step_plain rotates q, then k, in each layer),
    "bf16 q.k" (the cached keys' scores rounded to bf16 before their scale)
    and "bf16 P@V" (the P @ V sum over the cached keys rounded to bf16
    before the current token's term and the division). The last two round
    the result of one einsum of fused_decode_step_plain, which it makes
    once a layer; a run that makes another number raises."""

    EINSUMS = {"bf16 q.k": "bhgd,bshd->bhgs", "bf16 P@V": "bhgs,bshd->bhgd"}

    def __init__(self, variant: str, layers: int):
        self.variant, self.layers = variant, layers
        self.kf = kernel_module("fused_decode_step")

    def __enter__(self):
        import torch

        kf = self.kf
        self.saved = kf.unpack_int4, kf._rope, kf._round_pv, torch.einsum
        unpack, rope, _, einsum = self.saved
        calls = [0]
        self.calls = calls

        def swapped(q):
            lo, hi = unpack(q).chunk(2, dim=-1)
            return torch.cat([hi, lo], dim=-1)

        def unrotated_q(x, cos, sin):
            calls[0] += 1
            return x if calls[0] % 2 == 1 else rope(x, cos, sin)

        def rounded(spec, *ops):
            out = einsum(spec, *ops)
            if spec != self.EINSUMS[self.variant]:
                return out
            calls[0] += 1
            return out.to(torch.bfloat16).float()

        if self.variant == "nibble order":
            kf.unpack_int4 = swapped
        elif self.variant == "Q rotation":
            kf._rope = unrotated_q
        elif self.variant in self.EINSUMS:
            torch.einsum = rounded
        else:
            kf._round_pv = lambda pv: pv

    def __exit__(self, *exc):
        import torch

        (self.kf.unpack_int4, self.kf._rope, self.kf._round_pv,
         torch.einsum) = self.saved
        if (exc[0] is None and self.variant in self.EINSUMS
                and self.calls[0] != self.layers):
            raise AssertionError(f"w4a16_variant {self.variant!r}: "
                                 f"{self.calls[0]} rounded einsums, expected "
                                 f"{self.layers}")


def check_w4a16_rows(blocks, x, cache, args, kw, got, want, what,
                     unseparated: dict | None = None) -> str:
    """Hold K4 W4A16's x_out to its rule (W4A16_RULE), each row relative to
    its own norm, and every control of W4A16_CONTROLS to breaking it, but
    those named in `unseparated` ({control: why it cannot break the rule on
    these inputs}), which are reported. Returns the readings: the worst
    row's error over its bound, and each control's worst row over its
    bound."""
    import torch

    kf = kernel_module("fused_decode_step")
    layers = args[-1].num_layers

    def plain(args_=args):
        c = [t.clone() for t in cache]
        return kf.fused_decode_step_plain(blocks, x, *c, *args_,
                                          **kw)[0].float()

    err = rows_rel(got, want)
    with w4a16_variant("unrounded p*v", layers):
        spread = rows_rel(plain(), want)
    bound = (2 * spread).clamp_min(W4A16_RULE)
    controls = {}
    for name in W4A16_CONTROLS:
        if name == "first key":
            qslot, vfrom = args[0], args[1]
            controls[name] = rows_rel(
                plain((qslot, (vfrom + 1).minimum(qslot), *args[2:])), want)
        else:
            with w4a16_variant(name, layers):
                controls[name] = rows_rel(plain(), want)
    ratio = err / bound
    r = int(ratio.argmax())
    said = (f"worst row {r}: {float(err[r]):.4g} of its own norm "
            f"({float(want[r].norm()):.4g}, median "
            f"{float(want.norm(dim=-1).median()):.4g}), {float(ratio[r]):.3f} "
            f"of its bound {float(bound[r]):.4g} (2e-2, or twice its spread "
            f"with p * v_scale unrounded; the spread reads up to "
            f"{float(spread.max()):.4g}); controls, worst row over its bound: "
            + ", ".join(f"{n} {float((c / bound).max()):.3g}"
                        for n, c in controls.items()))
    unseparated = unseparated or {}
    for why in dict.fromkeys(unseparated.values()):
        said += "; not required: " + ", ".join(
            n for n, w in unseparated.items() if w == why) + f" ({why})"
    if not bool(torch.isfinite(err).all()) or float(ratio[r]) > 1:
        raise AssertionError(f"{what}: outside the rule; {said}")
    for name, c in controls.items():
        if not bool((c > bound).any()) and name not in unseparated:
            raise AssertionError(f"{what}: the control {name!r} keeps every "
                                 f"row within its bound too; {said}")
    return said


def slot_codes(got_c, want_c, slot: int, what: str, deep: bool = True,
               strict: int = 1) -> list:
    """The new K/V codes at `slot` of the kernel's cache against the plain
    version's. The first `strict` layers: within one level, >= 99.9% equal
    (layer 0 sees the same input, but the kernel's f32 sums, in WMMA tiles
    and k-splits, and the plain version's run in other orders, so a bf16
    rounding of qkv can flip); with `deep`, the later ones within one level
    on >= 99%. Returns the readings, with the scales' relative error."""
    notes = []
    for i, name in ((0, "k"), (2, "v")):
        d = (got_c[i][:, :, slot].int() - want_c[i][:, :, slot].int()).abs()
        eq = float((d[:strict] == 0).float().mean())
        if int(d[:strict].max()) > 1 or eq < 0.999:
            raise AssertionError(f"{what}: {name} codes of layers < {strict}: "
                                 f"max diff {int(d[:strict].max())}, equal "
                                 f"{eq:.5f}")
        note = f"{name} codes of layers < {strict} equal {eq:.5f}"
        if deep and strict < d.shape[0]:
            near = float((d[strict:] <= 1).float().mean())
            if near < 0.99:
                raise AssertionError(f"{what}: {name} codes of deeper layers "
                                     f"within one level {near:.5f}")
            note += f", deeper within one level {near:.5f}"
        notes.append(note)
    for i in (1, 3):
        sr = ((got_c[i][..., slot] - want_c[i][..., slot]).abs()
              / want_c[i][..., slot].abs()).max()
        notes.append(f"scale rel err {float(sr):.3g}")
    return notes


def check_w8a8_exact(blocks, x, cache, cfg, slot: int) -> str:
    """K4 W8A8 where no cached key is live (valid_from = q_slot): each row
    attends to its own token alone, so attention returns that token's V in
    both versions: the step is held to W8A8_OWN_TOKEN, the new codes of
    every layer to layer 0's rule, and the controls to failing the first."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import fused_decode as kf
    from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies

    B, dev = x.shape[0], x.device
    qslot = torch.full((B,), slot, dtype=torch.int32, device=dev)
    pos = torch.zeros(B, dtype=torch.long, device=dev)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len, device=dev)
    args = (qslot, qslot.clone(), cos[pos], sin[pos], cfg)
    kw = dict(slot=qslot, write_cache=True)
    got_c = [t.clone() for t in cache]
    want_c = [t.clone() for t in cache]
    got = kf.fused_decode_step(blocks, x, *got_c, *args, **kw)[0].float()
    want = kf.fused_decode_step_plain(blocks, x, *want_c, *args,
                                      **kw)[0].float()
    torch.cuda.synchronize()

    def plain():
        return kf.fused_decode_step_plain(
            blocks, x, *[t.clone() for t in cache], *args, **kw)[0].float()

    what = "K4 W8A8, no cached key"
    rows = w8a8_rows_ok(rows_rel(got, want),
                        w8a8_controls(plain, want, cfg.num_layers), what,
                        W8A8_OWN_TOKEN)
    codes = slot_codes(got_c, want_c, slot, what, strict=cfg.num_layers)
    return f"with no cached key x_out {rows}; {'; '.join(codes)}"


def check_fused(dev, flush, mode="w8a16", seed=SEED + 2, timed=True):
    """K4 in `mode` (FUSED_MODES) at the 7B widths, 2 layers, B = 64,
    S = 256, ragged valid_from, the generate path's in-place write at the
    write slots q_slot (read by the kernel from the device), on inputs made
    from `seed`. Returns (its entry (max_abs_err of x_out), timed, or None,
    and the worst row's relative error of x_out)."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import fused_decode as kf
    from physics_llm_inference_tpu_torch.models import quant
    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies

    init, act, name, _ = FUSED_MODES[mode]
    tag = "K4" if mode == "w8a16" else f"K4 {mode.upper()}"
    cfg = ModelConfig(num_layers=2, act_quant=act, **WIDTHS)
    g = torch.Generator(device=dev).manual_seed(seed)
    blocks = getattr(quant, init)(g, cfg)["blocks"]
    L, B, S, slot = 2, 64, 256, 200
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cache = []
    for _ in ("k", "v"):
        cache += [torch.randint(-127, 128, (L, B, S, hkv * hd),
                                dtype=torch.int8, generator=g, device=dev),
                  torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.03]
    x = (torch.randn((B, cfg.hidden_dim), generator=g, device=dev)
         * cfg.hidden_dim ** -0.5).bfloat16()
    qslot = torch.full((B,), slot, dtype=torch.int32, device=dev)
    vfrom = torch.randint(0, 128, (B,), generator=g, device=dev).int()
    pos = slot - vfrom
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    args = (qslot, vfrom, cos[pos], sin[pos], cfg)
    kw = dict(slot=qslot, write_cache=True)
    got_c = [t.clone() for t in cache]
    want_c = [t.clone() for t in cache]
    counter = KERNELS[name][1]
    before = getattr(kf, counter)
    got = kf.fused_decode_step(blocks, x, *got_c, *args, **kw)[0].float()
    want = kf.fused_decode_step_plain(blocks, x, *want_c, *args,
                                      **kw)[0].float()
    torch.cuda.synchronize()
    if getattr(kf, counter) != before + 1:
        raise AssertionError(f"{tag}: the launch did not go to {counter}")
    rel = row_rel(got, want)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: x_out not finite")
    if mode == "w8a8":
        def plain():
            return kf.fused_decode_step_plain(
                blocks, x, *[t.clone() for t in cache], *args, **kw)[0].float()

        rows = (w8a8_rows_ok(rows_rel(got, want), w8a8_controls(plain, want, L),
                             f"{tag} x_out")
                + "; " + check_w8a8_exact(blocks, x, cache, cfg, slot))
    elif mode == "w4a16":
        rows = check_w4a16_rows(blocks, x, cache, args, kw, got, want,
                                f"{tag} x_out")
    elif rel > 2e-2:
        raise AssertionError(f"{tag}: x_out row-wise relative error {rel:.4g} "
                             "> 2e-2")
    for i, name in enumerate(("k", "k scale", "v", "v scale")):
        a, b, c = got_c[i], want_c[i], cache[i]
        keep = torch.ones(S, dtype=torch.bool, device=dev)
        keep[slot] = False
        outside = (a[:, :, keep] if a.dtype == torch.int8
                   else a[..., keep])
        ref = c[:, :, keep] if a.dtype == torch.int8 else c[..., keep]
        if not torch.equal(outside, ref):
            raise AssertionError(f"{tag}: {name} cache changed outside the "
                                 "slot")
    # W8A8 holds its deeper layers' codes in check_w8a8_exact: here a flipped
    # activation code of layer 0 reaches them
    codes = slot_codes(got_c, want_c, slot, tag, deep=mode != "w8a8")
    # fixed-order sums, no float atomics: a second launch on the same
    # inputs gives the same bits
    again_c = [t.clone() for t in cache]
    again = kf.fused_decode_step(blocks, x, *again_c, *args, **kw)[0].float()
    if not torch.equal(again, got) or not all(
            torch.equal(a, b) for a, b in zip(again_c, got_c)):
        raise AssertionError(f"{tag}: two launches on the same inputs differ")
    err = float((got - want).abs().max())
    if not timed:
        log(f"{tag} seed {seed}: x_out row-wise rel err {rel:.4g}"
            f"{f' ({rows})' if mode != 'w8a16' else ''}; "
            f"{'; '.join(codes)}; two launches bit-equal")
        return None, rel
    ms = time_ms(lambda: kf.fused_decode_step(blocks, x, *got_c, *args, **kw),
                 flush)
    pms = time_ms(lambda: kf.fused_decode_step_plain(blocks, x, *want_c,
                                                     *args, **kw), flush)
    wbytes = sum(blocks[n].q.numel() for n in ("wqkv", "wo", "w_gate_up",
                                               "w_down"))
    live = int((qslot - vfrom).sum()) * L * hkv * hd * 2
    bound = entry(err, ms, pms, *fused_bound(
        blocks, x, L, hkv, hd, cfg.num_heads, int((qslot - vfrom).sum()), B,
        act))
    log(f"{tag} fused_decode_step 7B widths L={L} B={B} S={S}: x_out "
        f"row-wise rel err {rel:.4g} "
        f"({rows if mode != 'w8a16' else '2e-2'}), max abs {err:.4g}; "
        f"{'; '.join(codes)}; cache outside the slot unchanged; two launches "
        f"bit-equal; kernel {ms:.4f} ms "
        f"({(wbytes + live) / ms / 1e6:.0f} GB/s of weights + live KV), "
        f"plain {pms:.4f} ms, bound {bound['bound_ms']:.4f} ms; output "
        f"digest {digest(got, *got_c)}")
    return bound, rel


# the seeds K4 W8A16 and W4A16 are held at: check_fused's own and seven more
FUSED_SEEDS = tuple(SEED + 2 + 100 * i for i in range(8))


def fused_seeds(dev, flush):
    """K4 W8A16 and W4A16 under check_fused's rules at every seed of
    FUSED_SEEDS (the first is phase 3's timed run, here untimed); each
    seed's x_out row-wise error of the two modes side by side. Every seed
    runs and is logged before a seed that failed raises."""
    rels, failed = {"w8a16": [], "w4a16": []}, []
    for m in rels:
        for seed in FUSED_SEEDS:
            try:
                rel = check_fused(dev, flush, m, seed, timed=False)[1]
                rels[m].append(f"{rel:.4g}")
            except AssertionError as e:
                log(f"K4 {m.upper()} seed {seed} failed: {e}")
                rels[m].append("failed")
                failed.append(f"{m} seed {seed}")
    log("K4 x_out row-wise rel err by seed (W8A16, rule 2e-2 | W4A16, "
        "held to its rule, check_w4a16_rows): "
        + "; ".join(f"{seed}: {a} | {b}" for seed, a, b in
                    zip(FUSED_SEEDS, rels["w8a16"], rels["w4a16"])))
    if failed:
        raise AssertionError("K4 failed its rule at " + ", ".join(failed))


def check_fused_capture(dev):
    """K4 W8A16 (7B widths, 2 layers, B 8) captured once in a CUDA graph and
    replayed at two write slots set in its static slot buffer: each replay
    bit-equal to an eager launch at that slot (x_out and the whole cache),
    and the counter moved by one launch a replay."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import fused_decode as kf
    from physics_llm_inference_tpu_torch.models import quant
    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies
    from physics_llm_inference_tpu_torch.runtime.step_cache import \
        CapturedStep

    cfg = ModelConfig(num_layers=2, **WIDTHS)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    blocks = quant.init_params_int8(g, cfg)["blocks"]
    L, B, S = 2, 8, 256
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cache = []
    for _ in ("k", "v"):
        cache += [torch.randint(-127, 128, (L, B, S, hkv * hd),
                                dtype=torch.int8, generator=g, device=dev),
                  torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.03]
    x = (torch.randn((B, cfg.hidden_dim), generator=g, device=dev)
         * cfg.hidden_dim ** -0.5).bfloat16()
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    slot = torch.zeros(B, dtype=torch.int32, device=dev)
    vfrom = torch.zeros(B, dtype=torch.int32, device=dev)
    pos = torch.zeros(B, dtype=torch.long, device=dev)
    graph_c = [t.clone() for t in cache]

    def step():
        return kf.fused_decode_step(blocks, x, *graph_c, slot, vfrom,
                                    cos[pos], sin[pos], cfg, slot=slot,
                                    write_cache=True)[0]

    captured = CapturedStep(step, dev)
    for at in (120, 121):
        graph_c[:] = [t.copy_(c) for t, c in zip(graph_c, cache)]
        slot.fill_(at)
        pos.fill_(at)
        before = kf.launches
        got = captured().clone()
        eager_c = [t.clone() for t in cache]
        want = kf.fused_decode_step(blocks, x, *eager_c, slot, vfrom,
                                    cos[pos], sin[pos], cfg, slot=slot,
                                    write_cache=True)[0]
        torch.cuda.synchronize()
        if kf.launches != before + 2:
            raise AssertionError("K4 replay: the launch counter moved by "
                                 f"{kf.launches - before - 1}, not 1")
        if not torch.equal(got, want) or not all(
                torch.equal(a, b) for a, b in zip(graph_c, eager_c)):
            raise AssertionError(f"K4 replay at slot {at}: not bit-equal to "
                                 "an eager launch")
        if torch.equal(graph_c[0][:, :, at], cache[0][:, :, at]):
            raise AssertionError(f"K4 replay: nothing written at slot {at}")
    log("K4 W8A16 captured once, replayed at slots 120 and 121: x_out and "
        "cache bit-equal to eager launches, one launch counted a replay")


def clock_reading(kf, clock, blocks, L: int, mode: int):
    """Each phase's mean us a layer from a phase_clock buffer, and for the
    GEMM phases the GB/s of that layer's weights (codes and scales): the
    line, and {phase: us a layer}."""
    names = kf.PHASES_W8A8 if mode == kf.W8A8 else kf.PHASES
    t = clock.cpu().double()
    if bool((t[1:] <= t[:-1]).any()):
        raise AssertionError("phase clock: stamps not increasing")
    dt = (t[1:] - t[:-1]).reshape(L, len(names)) / 1e3   # us
    parts, by_phase = [], {}
    for i, name in enumerate(names):
        us = by_phase[name] = float(dt[:, i].mean())
        part = f"{name} {us:.2f}"
        if name in kf.GEMM_PHASES:
            w = blocks[kf.GEMM_PHASES[name]]
            gb = nbytes(w.q, w.s) / L / 1e9
            part += f" ({gb / us * 1e6:.0f} GB/s)"
        parts.append(part)
    return (f"{float(dt.sum()) / L:.2f} us a layer, {float(dt.sum()) / 1e3:.3f}"
            f" ms in all; us a layer: " + ", ".join(parts)), by_phase


def phase_clock(dev):
    """Phase 3b: one clocked launch of each K4 mode at 32 layers, B 64, S
    256 (as check_fused, deeper), then of K8 at 32 layers in the engine's
    geometry (B 64, BS 512, MB 2, NB 161) on the W8A16 weights. Each
    follows an unclocked warm-up launch; no clocked launch is timed."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import fused_decode as kf
    from physics_llm_inference_tpu_torch.models import quant
    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies

    L, B, S, slot = 32, 64, 256, 200
    cfg = ModelConfig(num_layers=L, **WIDTHS)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    x = (torch.randn((B, cfg.hidden_dim), generator=g, device=dev)
         * cfg.hidden_dim ** -0.5).bfloat16()
    cache = []
    for _ in ("k", "v"):
        cache += [torch.randint(-127, 128, (L, B, S, hkv * hd),
                                dtype=torch.int8, generator=g, device=dev),
                  torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.03]
    qslot = torch.full((B,), slot, dtype=torch.int32, device=dev)
    vfrom = torch.randint(0, 128, (B,), generator=g, device=dev).int()
    pos = slot - vfrom
    # the attention phase reads each live cached key's K/V codes and scales
    kv_bytes = int((slot - vfrom).sum()) * hkv * (2 * hd + 8)
    attention = []
    weights = {}
    for mode, (init, act, _, _) in FUSED_MODES.items():
        mcfg = ModelConfig(num_layers=L, act_quant=act, **WIDTHS)
        if init not in weights:
            weights[init] = getattr(quant, init)(
                torch.Generator(device=dev).manual_seed(SEED), mcfg)["blocks"]
        blocks = weights[init]
        args = (qslot, vfrom, cos[pos], sin[pos], mcfg)
        kmode = kf.fused_decode_mode(blocks, mcfg)
        clock = kf.phase_clock(L, kmode, dev)
        kf.fused_decode_step(blocks, x, *cache, *args)
        kf.fused_decode_step(blocks, x, *cache, *args, clock=clock)
        torch.cuda.synchronize()
        line, us = clock_reading(kf, clock, blocks, L, kmode)
        log(f"phase clock, K4 {mode.upper()} L={L} B={B} S={S}: {line}")
        attention.append(f"K4 {mode.upper()} {us['attention']:.2f} "
                         f"({kv_bytes / us['attention'] / 1e3:.0f} GB/s)")
    blocks = weights.pop("init_params_int8")
    del cache, weights
    torch.cuda.empty_cache()
    BS, MB, NB = 512, 2, 161
    lens = torch.randint(1, MB * BS, (B,), generator=g, device=dev)
    tables = _scattered_tables(g, dev, B, MB, NB, lens // BS + 1, NB - 1)
    kv = torch.randint(-127, 128, (L, NB, 2, BS, hkv * hd), dtype=torch.int8,
                       generator=g, device=dev)
    kvs = torch.rand((L, NB, 2, hkv, BS), generator=g, device=dev) * 0.03
    args = (tables, lens.int(), cos[lens], sin[lens], cfg)
    clock = kf.phase_clock(L, kf.W8A16, dev)
    kf.fused_paged_decode_step(blocks, x, kv, kvs, *args, inplace=True)
    kf.fused_paged_decode_step(blocks, x, kv, kvs, *args, inplace=True,
                               clock=clock)
    torch.cuda.synchronize()
    line, us = clock_reading(kf, clock, blocks, L, kf.W8A16)
    log(f"phase clock, K8 L={L} B={B} BS={BS} MB={MB} NB={NB}: {line}")
    kv_bytes = int(lens.sum()) * hkv * (2 * hd + 8)
    attention.append(f"K8 {us['attention']:.2f} "
                     f"({kv_bytes / us['attention'] / 1e3:.0f} GB/s)")
    log("phase clock, attention phase, us a layer (GB/s of live KV codes "
        "and scales): " + ", ".join(attention))
    del kv, kvs, blocks
    torch.cuda.empty_cache()


def check_flash(dev, flush):
    """K5 at B = 64, Hq = 32, Hkv = 8, d = 128: square Sq = Sk = 512 and the
    rectangular Sq = 128, q_offset = 512, Sk = 640, ragged valid_from; then
    where the design can break (flash_cases); then the sweep. Returns the
    square case's entry (max_abs_err on live rows), with the time of
    scaled_dot_product_attention(attn_mask=K5's mask, enable_gqa=True) as
    its library call."""
    import torch

    import torch.nn.functional as F

    from physics_llm_inference_tpu_torch.kernels import flash_attention as kfa

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    B, hq, hkv, d = 64, 32, 8, 128
    first = None
    for sq, sk, qoff in ((512, 512, 0), (128, 640, 512)):
        q = torch.randn((B, sq, hq, d), generator=g, device=dev).bfloat16()
        k = torch.randn((B, sk, hkv, d), generator=g, device=dev).bfloat16()
        v = torch.randn((B, sk, hkv, d), generator=g, device=dev).bfloat16()
        vfrom = torch.randint(0, 384, (B,), generator=g, device=dev).int()
        # (B, S, H, d) views, as block_forward hands them over
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        kw = dict(q_offset=qoff, causal=True, valid_from=vfrom)
        err = flash_err(kfa, args, kw, f"Sq={sq} Sk={sk}")
        ms = time_ms(lambda: kfa.flash_attention(*args, **kw), flush)
        pms = time_ms(lambda: kfa.flash_attention_plain(*args, **kw), flush,
                      reps=5, warmup=1)
        qpos = qoff + torch.arange(sq, device=dev)
        pairs = (qpos[None, :] - vfrom[:, None] + 1).clamp_min(0).sum()
        flop = 4 * d * hq * int(pairs)
        kpos = torch.arange(sk, device=dev)
        mask = ((kpos[None, None, :] <= qpos[None, :, None])
                & (kpos[None, None, :] >= vfrom[:, None, None]))[:, None]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            *args, attn_mask=mask, enable_gqa=True), flush)
        # the same call on K/V expanded to the query heads outside the
        # timed region, where the memory-efficient backend takes the mask
        kx, vx = (t.repeat_interleave(hq // hkv, dim=1) for t in args[1:])
        lib_x = time_ms(lambda: F.scaled_dot_product_attention(
            args[0], kx, vx, attn_mask=mask), flush)
        del kx, vx
        log(f"K5 flash_attention B={B} Hq={hq} Hkv={hkv} d={d} Sq={sq} "
            f"Sk={sk} q_offset={qoff}, ragged valid_from: max abs err on "
            f"live rows {err:.4g} (atol 2e-2), two launches bit-equal, "
            f"kernel {ms:.4f} ms "
            f"({flop / ms / 1e9:.1f} TFLOP/s of live causal work), plain "
            f"{pms:.4f} ms; scaled_dot_product_attention(mask, enable_gqa) "
            f"{lib:.4f} ms, on K/V expanded to {hq} heads {lib_x:.4f} ms")
        first = first or entry(err, ms, pms, nbytes(q, k, v, q, vfrom), flop,
                               library_ms=lib)
    flash_cases(dev, g, flush)
    flash_sweep(dev, g, flush)
    return first


def flash_err(kfa, args, kw, what) -> float:
    """K5 against its plain version: the max abs error on live rows (a query
    at or past its request's valid_from) within 2e-2, finite everywhere, and
    a second launch bit-equal to the first."""
    import torch

    got = kfa.flash_attention(*args, **kw)
    again = kfa.flash_attention(*args, **kw)
    want = kfa.flash_attention_plain(*args, **kw).float()
    torch.cuda.synchronize()
    b, _, sq, _ = args[0].shape
    dev = got.device
    qoff = torch.as_tensor(kw.get("q_offset", 0), device=dev).reshape(-1, 1)
    vfrom = kw.get("valid_from")
    vfrom = torch.zeros(b, device=dev) if vfrom is None else vfrom
    live = (qoff + torch.arange(sq, device=dev)) >= vfrom[:, None]
    err = float((got.float() - want).abs().transpose(1, 2)[live].max())
    if not bool(torch.isfinite(got).all()) or err > 2e-2:
        raise AssertionError(f"K5 {what}: max abs err on live rows "
                             f"{err:.4g} > 2e-2")
    if not torch.equal(got, again):
        raise AssertionError(f"K5 {what}: two launches differ")
    return err


def flash_cases(dev, g, flush):
    """K5 where its design can break: the paged chunk's shape (a per-request
    q_offset tensor, Sk = MB x BS = 1024, kv_len < Sk), GQA groups 1 and 8
    (128 and 16 positions a block), head_dim 64, and an Sq that is not a
    multiple of the q tile (group 4: 32 positions)."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import flash_attention as kfa

    cases = {  # name: (B, Sq, Sk, Hq, Hkv, d, q_offset, kv_len, valid_from)
        "paged chunk": (64, 128, 1024, 32, 8, 128, "per-request", 1000, None),
        "group 1": (16, 512, 512, 8, 8, 128, 0, None, "ragged"),
        "group 8": (16, 512, 512, 32, 4, 128, 0, None, "ragged"),
        "d 64": (16, 512, 512, 32, 8, 64, 0, None, "ragged"),
        "Sq 100": (16, 100, 612, 32, 8, 128, 512, None, "ragged"),
    }
    for name, (B, sq, sk, hq, hkv, d, qoff, kv_len, vfrom) in cases.items():
        q = torch.randn((B, sq, hq, d), generator=g, device=dev).bfloat16()
        k = torch.randn((B, sk, hkv, d), generator=g, device=dev).bfloat16()
        v = torch.randn((B, sk, hkv, d), generator=g, device=dev).bfloat16()
        if qoff == "per-request":   # chunk starts; request 0's passes kv_len
            qoff = torch.randint(0, sk - sq + 1, (B,), generator=g,
                                 device=dev).int()
            qoff[0] = sk - sq
        if vfrom == "ragged":
            vfrom = torch.randint(0, min(sq, 384), (B,), generator=g,
                                  device=dev).int()
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        kw = dict(q_offset=qoff, causal=True, kv_len=kv_len, valid_from=vfrom)
        err = flash_err(kfa, args, kw, name)
        ms = time_ms(lambda: kfa.flash_attention(*args, **kw), flush)
        log(f"K5 {name}: B={B} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} d={d} "
            f"kv_len={kv_len}: max abs err on live rows {err:.4g} (atol "
            f"2e-2), two launches bit-equal, kernel {ms:.4f} ms")


def flash_sweep(dev, g, flush):
    """Log only: K5 against scaled_dot_product_attention(is_causal=True,
    enable_gqa=True) on the same causal mask at bench_attention's shape (B
    4, Hq 16, Hkv 4, d 128), S = 512 to 8192, in TFLOP/s of causal work."""
    import torch

    import torch.nn.functional as F

    from physics_llm_inference_tpu_torch.kernels import flash_attention as kfa

    B, hq, hkv, d = 4, 16, 4, 128
    for s in (512, 1024, 2048, 4096, 8192):
        q = torch.randn((B, hq, s, d), generator=g, device=dev).bfloat16()
        k = torch.randn((B, hkv, s, d), generator=g, device=dev).bfloat16()
        v = torch.randn((B, hkv, s, d), generator=g, device=dev).bfloat16()
        ms = time_ms(lambda: kfa.flash_attention(q, k, v), flush)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), flush)
        flop = 4 * B * hq * s * s * d * 0.5
        log(f"K5 sweep S={s}: kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} "
            f"TFLOP/s), scaled_dot_product_attention(is_causal, enable_gqa) "
            f"{lib:.4f} ms ({flop / lib / 1e9:.1f} TFLOP/s)")


def _scattered_tables(g, dev, B, MB, NB, used, trash):
    """Block tables drawn from a permutation of the pool's blocks: request
    b's first used[b] columns; the other columns on the trash block."""
    import torch

    perm = torch.randperm(NB - 1, generator=g, device=dev)[:B * MB]
    tables = perm.reshape(B, MB).to(torch.int32)
    cols = torch.arange(MB, device=dev)[None, :]
    return torch.where(cols < used[:, None], tables,
                       torch.full_like(tables, trash))


def check_paged_attention(dev, flush) -> dict:
    """K6 (INT8 merged pools) and K7 (bf16 pools) at B = 64, Hq 32, Hkv 8,
    d 128 over 2-layer pools, in the per-op route's geometry (BS 16, MB 64)
    and the default one (BS 512, MB 2): scattered tables, ragged lengths
    with 1, block boundaries and the whole table; then K7 at d 120. Returns
    their entries, from the per-op geometry that the engine's per-op routes
    run."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import paged_attention as kp

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    B, hq, hkv, d, L = 64, 32, 8, 128, 2
    out = {}
    for bs, mb in ((16, 64), (512, 2)):
        cap, NB = bs * mb, B * mb + 17
        lens = torch.randint(1, cap + 1, (B,), generator=g, device=dev)
        lens[:6] = torch.tensor([1, bs, bs + 1, cap - 1, cap, 2 * bs],
                                device=dev)
        tables = _scattered_tables(g, dev, B, mb, NB, -(-lens // bs), NB - 1)
        ctx = lens.int()
        q = torch.randn((B, hq, d), generator=g, device=dev).bfloat16()
        kv = torch.randint(-127, 128, (L, NB, 2, bs, hkv * d),
                           dtype=torch.int8, generator=g, device=dev)
        kvs = torch.rand((L, NB, 2, hkv, bs), generator=g, device=dev) * 0.03
        kpool = torch.randn((L, NB, bs, hkv, d), generator=g,
                            device=dev).bfloat16()
        vpool = torch.randn((L, NB, bs, hkv, d), generator=g,
                            device=dev).bfloat16()
        cases = (("int8_paged_decode_attention", "K6", kv, kvs, 1),
                 ("paged_decode_attention", "K7", kpool, vpool, 2))
        for name, tag, a, b, elt in cases:
            fn, plain = getattr(kp, name), getattr(kp, f"{name}_plain")
            args = (q, a, b, tables, ctx)
            got = fn(*args, layer=1).float()
            want = plain(*args, layer=1).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            # other f32 summation orders, a tile-wise online softmax (K6:
            # p * v_scale rounded to bf16 against its running max), bf16 out
            if not bool(torch.isfinite(got).all()) or err > 2e-2:
                raise AssertionError(f"{tag} BS={bs}: max abs err {err:.4g} "
                                     "> 2e-2")
            if not torch.equal(fn(*args, layer=1).float(), got):
                raise AssertionError(f"{tag} BS={bs}: two launches differ")
            ms = time_ms(lambda f=fn, x=args: f(*x, layer=1), flush)
            pms = time_ms(lambda f=plain, x=args: f(*x, layer=1), flush)
            live = int(lens.sum()) * hkv * d * 2 * elt
            log(f"{tag} {name} B={B} Hq={hq} Hkv={hkv} d={d} BS={bs} MB={mb} "
                f"(scattered tables, ragged lengths): max_abs_err {err:.4g} "
                f"(atol 2e-2), two launches bit-equal, kernel {ms:.4f} ms "
                f"({live / ms / 1e6:.0f} GB/s of live KV), plain {pms:.4f} ms")
            if bs == 16:
                keys = int(lens.sum())
                out[name] = entry(
                    err, ms, pms, keys * hkv * (2 * d * elt + (8 if elt == 1
                                                               else 0))
                    + 2 * nbytes(q) + nbytes(tables, ctx), 4 * hq * d * keys)
    # K7 at head_dim 120 (a multiple of 8, not of 16: the loop zero-fills
    # its last k16 chunk) in the per-op geometry, over the same tables
    d = 120
    bs, mb = 16, 64
    NB = B * mb + 17
    lens = torch.randint(1, bs * mb + 1, (B,), generator=g, device=dev)
    tables = _scattered_tables(g, dev, B, mb, NB, -(-lens // bs), NB - 1)
    q = torch.randn((B, hq, d), generator=g, device=dev).bfloat16()
    kpool, vpool = (torch.randn((L, NB, bs, hkv, d), generator=g,
                                device=dev).bfloat16() for _ in "kv")
    args = (q, kpool, vpool, tables, lens.int())
    got = kp.paged_decode_attention(*args, layer=1).float()
    want = kp.paged_decode_attention_plain(*args, layer=1).float()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > 2e-2:
        raise AssertionError(f"K7 d={d}: max abs err {err:.4g} > 2e-2")
    if not torch.equal(kp.paged_decode_attention(*args, layer=1).float(), got):
        raise AssertionError(f"K7 d={d}: two launches differ")
    ms = time_ms(lambda: kp.paged_decode_attention(*args, layer=1), flush)
    live = int(lens.sum()) * hkv * d * 2 * 2
    log(f"K7 paged_decode_attention B={B} Hq={hq} Hkv={hkv} d={d} BS={bs} "
        f"MB={mb}: max_abs_err {err:.4g} (atol 2e-2), two launches bit-equal, "
        f"kernel {ms:.4f} ms ({live / ms / 1e6:.0f} GB/s of live KV)")
    return out


def check_fused_paged(dev, flush):
    """K8 at the 7B widths, 2 layers, in the engine's default geometry:
    B = 64, BS = 512, MB = 2, NB = 161 (160 blocks + the trash block), in
    place. Scattered tables covering each active row's write position,
    ragged lengths with block-boundary rows, and 8 inactive rows on the
    trash block with stale lengths (up to past the table). Returns its
    entry (max_abs_err of x_out on the active rows)."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import fused_decode as kf
    from physics_llm_inference_tpu_torch.kernels.paged_attention import \
        write_position
    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import init_params_int8
    from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies

    cfg = ModelConfig(num_layers=2, **WIDTHS)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    blocks = init_params_int8(g, cfg)["blocks"]
    L, B, BS, MB, NB = 2, 64, 512, 2, 161
    trash, cap = NB - 1, MB * BS
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    lens = torch.randint(1, cap, (B,), generator=g, device=dev)
    lens[:6] = torch.tensor([BS - 1, BS, BS + 1, 1, cap - 1, 2 * BS - 2],
                            device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[-8:] = False
    lens[-8:] = torch.tensor([0, 5, BS, cap - 1, cap, cap + 3, 700, 1],
                             device=dev)
    used = torch.where(active, lens // BS + 1, torch.zeros_like(lens))
    tables = _scattered_tables(g, dev, B, MB, NB, used, trash)
    kv = torch.randint(-127, 128, (L, NB, 2, BS, hkv * hd), dtype=torch.int8,
                       generator=g, device=dev)
    kvs = torch.rand((L, NB, 2, hkv, BS), generator=g, device=dev) * 0.03
    x = (torch.randn((B, cfg.hidden_dim), generator=g, device=dev)
         * cfg.hidden_dim ** -0.5).bfloat16()
    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    pos = lens.clamp(max=cfg.max_seq_len - 1)
    args = (tables, lens.int(), cos[pos], sin[pos], cfg)
    got_p, want_p = [kv.clone(), kvs.clone()], [kv.clone(), kvs.clone()]
    got = kf.fused_paged_decode_step(blocks, x, *got_p, *args, inplace=True)
    want = kf.fused_paged_decode_step_plain(blocks, x, *want_p, *args,
                                            inplace=True)
    torch.cuda.synchronize()
    xa, xw = got[0].float()[active], want[0].float()[active]
    rel = row_rel(xa, xw)
    if not bool(torch.isfinite(got[0]).all()) or rel > 2e-2:
        raise AssertionError(f"K8: x_out row-wise relative error {rel:.4g} "
                             "> 2e-2 on the active rows")
    codes = []
    for i, name in ((1, "k"), (3, "v")):
        d = (got[i].int() - want[i].int()).abs()
        # layer 0 sees the same x on every row; the kernel's f32 sums and
        # cuBLAS's run in other orders, so a bf16 rounding of qkv can flip
        l0 = float((d[0] == 0).float().mean())
        deep = float((d[1:][:, active] <= 1).float().mean())
        if int(d[0].max()) > 1 or l0 < 0.999 or deep < 0.99:
            raise AssertionError(f"K8: {name} codes: layer 0 max diff "
                                 f"{int(d[0].max())}, equal {l0:.5f}; deeper "
                                 f"within one level {deep:.5f}")
        codes.append(f"{name} layer-0 codes equal {l0:.5f}, deeper within "
                     f"one level {deep:.5f}")
    # the pools: unchanged outside the written slots and the trash block;
    # each active row's slot holds the codes the launch returned
    blk, off = write_position(tables, lens, BS)
    keep = torch.ones((NB, BS), dtype=torch.bool, device=dev)
    keep[blk, off] = False
    keep[trash] = False
    for p in (got_p, want_p):
        if not (torch.equal(p[0].transpose(2, 3)[:, keep],
                            kv.transpose(2, 3)[:, keep])
                and torch.equal(p[1].permute(0, 1, 4, 2, 3)[:, keep],
                                kvs.permute(0, 1, 4, 2, 3)[:, keep])):
            raise AssertionError("K8: the pools changed outside the written "
                                 "slots and the trash block")
    ba, oa = blk[active], off[active]
    if not (torch.equal(got_p[0][:, ba, 0, oa], got[1][:, active])
            and torch.equal(got_p[0][:, ba, 1, oa], got[3][:, active])
            and torch.equal(got_p[1][:, ba, 0, :, oa],
                            got[2][:, active].transpose(0, 1))
            and torch.equal(got_p[1][:, ba, 1, :, oa],
                            got[4][:, active].transpose(0, 1))):
        raise AssertionError("K8: a written slot differs from the returned "
                             "codes")
    # fixed-order sums, no float atomics: a second launch on the same
    # inputs gives the same bits on the active rows and outside the trash
    again_p = [kv.clone(), kvs.clone()]
    again = kf.fused_paged_decode_step(blocks, x, *again_p, *args,
                                       inplace=True)
    if not torch.equal(again[0][active], got[0][active]) or not all(
            torch.equal(a[:, :trash], b[:, :trash])
            for a, b in zip(again_p, got_p)):
        raise AssertionError("K8: two launches on the same inputs differ")
    err = float((xa - xw).abs().max())
    ms = time_ms(lambda: kf.fused_paged_decode_step(blocks, x, *got_p, *args,
                                                    inplace=True), flush)
    pms = time_ms(lambda: kf.fused_paged_decode_step_plain(
        blocks, x, *want_p, *args, inplace=True), flush)
    wbytes = sum(blocks[n].q.numel() for n in ("wqkv", "wo", "w_gate_up",
                                               "w_down"))
    live = int(lens[active].sum()) * L * hkv * hd * 2
    log(f"K8 fused_paged_decode_step 7B widths L={L} B={B} BS={BS} MB={MB} "
        f"NB={NB}, in place, 8 inactive rows on the trash block: x_out "
        f"row-wise rel err {rel:.4g} (2e-2) on the active rows, max abs "
        f"{err:.4g}; {'; '.join(codes)}; pools unchanged outside the written "
        f"slots and the trash block; two launches bit-equal; kernel "
        f"{ms:.4f} ms ({(wbytes + live) / ms / 1e6:.0f} GB/s of weights + "
        f"live KV), plain {pms:.4f} ms; output digest "
        f"{digest(got[0][active], *(t[:, active] for t in got[1:5]))}")
    b, f = fused_bound(blocks, x, L, hkv, hd, cfg.num_heads,
                       int(lens[active].sum()), int(active.sum()))
    return entry(err, ms, pms, b + nbytes(tables, lens.int()), f)


def check_teaching(dev, flush) -> dict:
    """K9 at 4096^3 bf16 (and 2048^3 f32), K10 and K11 at the membench
    default of 256 MiB (K11 also at 2 GiB) and K12 at (524288, 128) f32 (and
    bf16), each against its plain version and timed beside its library
    call. Returns the entries of the microbenchmark path's shapes."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import hello_pallas as kv
    from physics_llm_inference_tpu_torch.kernels import matmul as kt
    from physics_llm_inference_tpu_torch.kernels import membench as kb

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = {}
    # K9: another f32 summation order, then one cast: bf16 rtol 1e-2 plus
    # 1e-3 of the output's max (as K1); f32 in full f32 on both sides
    # (allow_tf32 off) rtol 1e-4 plus 1e-4 of the max. Each shape must go
    # through its route's counter: 4096^3 and the ragged (100, 72, 200)
    # bf16 through wgmma (TMA zero-fills past M, N and K), N % 8 != 0
    # through WMMA
    counters = {"wgmma": "launches", "wmma": "wmma_launches",
                "f32": "f32_launches"}
    for (m, k, n), dtype, rtol, atol, body in (
            ((4096,) * 3, torch.bfloat16, 1e-2, 1e-3, "wgmma"),
            ((2048,) * 3, torch.float32, 1e-4, 1e-4, "f32"),
            ((100, 72, 200), torch.bfloat16, 1e-2, 1e-3, "wgmma"),
            ((256, 256, 100), torch.bfloat16, 1e-2, 1e-3, "wmma")):
        a = torch.randn((m, k), generator=g, device=dev).to(dtype)
        b = torch.randn((k, n), generator=g, device=dev).to(dtype)
        before = {c: getattr(kt, c) for c in counters.values()}
        got = kt.tiled_matmul(a, b).float()
        moved = {c: getattr(kt, c) - before[c] for c in counters.values()}
        if moved != {c: int(c == counters[body]) for c in counters.values()}:
            raise AssertionError(f"K9 ({m},{k},{n}) {dtype}: route counters "
                                 f"moved {moved}, expected {body}")
        want = kt.tiled_matmul_plain(a, b).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        bound = rtol * want.abs() + atol * float(want.abs().max())
        if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
            raise AssertionError(f"K9 ({m},{k},{n}) {dtype}: max err "
                                 f"{float(err.max()):.4g} exceeds rtol {rtol}")
        what = (f"K9 tiled_matmul ({m},{k},{n}) {str(dtype)[6:]} via {body}: "
                f"max_abs_err {float(err.max()):.4g} (rtol {rtol} + {atol} "
                f"of the max)")
        if m < 1024:
            log(what)
            continue
        ms = time_ms(lambda: kt.tiled_matmul(a, b), flush)
        pms = time_ms(lambda: kt.tiled_matmul_plain(a, b), flush)
        lib = time_ms(lambda: torch.matmul(a, b), flush)
        flop = 2 * m * n * k
        log(f"{what}, kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s), "
            f"plain {pms:.4f} ms, torch.matmul {lib:.4f} ms "
            f"({flop / lib / 1e9:.1f} TFLOP/s)")
        if "tiled_matmul" not in out:
            out["tiled_matmul"] = entry(
                float(err.max()), ms, pms, 3 * nbytes(a), flop,
                "bf16" if dtype == torch.bfloat16 else "fp32", lib)
        del a, b, got, want, err, bound

    # K10/K11 at 256 MiB (K11 also at 2 GiB), f32 (N, 128): bit-equal to
    # the plain version and the library call, each timed; then ragged and
    # unaligned shapes
    for mib in (256, 2048):
        x = torch.randn((mib * (1 << 20) // 512, 128), generator=g,
                        device=dev)
        cases = [("strided_copy", "K11", kb._strided_copy,
                  kb._strided_copy_plain,
                  lambda: x.view(-1, 32, 8, 128)[:, 0].contiguous().view(-1, 128))]
        if mib == 256:
            cases.insert(0, ("stream_copy", "K10", kb._stream_copy,
                             kb._stream_copy_plain, x.clone))
        for name, tag, fn, plain, library in cases:
            got = fn(x)
            want = plain(x)
            if not torch.equal(got, want) or not torch.equal(got, library()):
                raise AssertionError(f"{tag} at {mib} MiB: not bit-equal")
            ms = time_ms(lambda: fn(x), flush)
            pms = time_ms(lambda: plain(x), flush)
            lib = time_ms(library, flush)
            moved = 2 * nbytes(got)
            log(f"{tag} {name} {mib} MiB: bit-equal to plain and library, "
                f"kernel {ms:.4f} ms ({moved / ms / 1e6:.0f} GB/s read + "
                f"write), plain {pms:.4f} ms, library {lib:.4f} ms "
                f"({moved / lib / 1e6:.0f} GB/s)")
            if mib == 256:
                out[name] = entry(0.0, ms, pms, moved, 0, library_ms=lib)
            del got, want
        del x
        torch.cuda.empty_cache()
    # ragged row blocks (a 16-byte multiple and not), odd offsets
    base = torch.randint(0, 256, (3 * 40960 + 48,), dtype=torch.uint8,
                         generator=g, device=dev)
    for off, lanes, rows, stride in ((0, 4096, 3, 1), (0, 20480, 1, 2),
                                     (16, 4096, 2, 3), (1, 4096, 1, 1),
                                     (0, 4088, 2, 2)):
        xr = base[off:off + lanes * ((base.numel() - off) // lanes)].view(
            -1, lanes)
        blocks = xr.shape[0] // (rows * stride)
        if not torch.equal(kb._row_block_copy(xr, rows, stride, blocks),
                           kb._row_blocks_plain(xr, rows, stride, blocks)):
            raise AssertionError(f"K10/K11 at offset {off}, {lanes} lanes, "
                                 f"{rows} rows, stride {stride}: not "
                                 "byte-equal")
    log("K10/K11 byte-equal at ragged and unaligned row blocks")

    # K12 at (524288, 128) f32 and bf16: bit-equal to a + b and torch.add,
    # each timed; then ragged and unaligned sizes
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn((524288, 128), generator=g, device=dev).to(dtype)
        b = torch.randn((524288, 128), generator=g, device=dev).to(dtype)
        got = kv.vector_add(a, b)
        if not (torch.equal(got, kv.vector_add_plain(a, b))
                and torch.equal(got, torch.add(a, b))):
            raise AssertionError(f"K12 {dtype}: not bit-equal to a + b")
        ms = time_ms(lambda: kv.vector_add(a, b), flush)
        pms = time_ms(lambda: kv.vector_add_plain(a, b), flush)
        lib = time_ms(lambda: torch.add(a, b), flush)
        moved = 3 * nbytes(a)
        log(f"K12 vector_add (524288, 128) {str(dtype)[6:]}: bit-equal to "
            f"a + b and torch.add, kernel {ms:.4f} ms "
            f"({moved / ms / 1e6:.0f} GB/s), plain {pms:.4f} ms, "
            f"torch.add {lib:.4f} ms")
        if "vector_add" not in out:
            out["vector_add"] = entry(0.0, ms, pms, moved, a.numel(), "fp32",
                                      lib)
        del a, b, got
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.randn(3 * 999_983 + 8, generator=g,
                           device=dev).to(dtype)
        for off, rows, cols in ((0, 999_983, 3), (1, 1, 999_983 * 3),
                                (0, 4096, 257), (8, 2048, 8)):
            a = flat[off:off + rows * cols].view(rows, cols)
            b = flat[-rows * cols:].view(rows, cols)
            if not torch.equal(kv.vector_add(a, b, block_rows=rows),
                               torch.add(a, b)):
                raise AssertionError(f"K12 {dtype} at offset {off}, "
                                     f"({rows}, {cols}): not bit-equal to "
                                     "torch.add")
    log("K12 bit-equal to torch.add at ragged and unaligned sizes")
    return out


def run_slice(params, cfg, prompts, steps_tokens, dev):
    """Prefill + teacher-forced decode steps; returns the prefill logits and,
    per step, the final hidden state handed to the greedy head and the
    tokens it returned."""
    import torch

    from physics_llm_inference_tpu_torch.models import transformer as tf
    from physics_llm_inference_tpu_torch.runtime import generate as gen
    from physics_llm_inference_tpu_torch.runtime.kv_cache import KVCache

    seen = []
    head = tf.lmhead_greedy

    def spy(x, *a, **kw):
        tok = head(x, *a, **kw)
        seen.append((x.float().clone(), tok.clone()))
        return tok

    tf.lmhead_greedy = spy
    try:
        ids, lens = gen.pad_and_stack(prompts, device=dev)
        b, p = ids.shape
        cache = KVCache.create(cfg, b, p + len(steps_tokens),
                               dtype=torch.int8, device=dev)
        logits0, kv, vfrom = gen._prefill(params, cfg, ids, lens,
                                          cache.as_slice())
        for i, tok in enumerate(steps_tokens):
            slot = p + i
            _, kv = tf.forward(
                params, tok[:, None], cfg, kv=tf.KVSlice(kv.k, kv.v, slot),
                positions=(lens + i)[:, None],
                slots=torch.full((b, 1), slot, dtype=torch.int32, device=dev),
                valid_from=vfrom, last_only=True, greedy_head=True)
        torch.cuda.synchronize()
    finally:
        tf.lmhead_greedy = head
    return logits0, seen


class plain_entry_points:
    """Within the block, the dense and the paged model's and the routed
    FFN's references to every kernel entry point are its plain version
    (here, not in the package)."""

    def __enter__(self):
        from physics_llm_inference_tpu_torch.models import moe as mo
        from physics_llm_inference_tpu_torch.models import \
            paged_transformer as pt
        from physics_llm_inference_tpu_torch.models import transformer as tf

        self.saved = [(m, n, getattr(m, n)) for m in (tf, pt, mo)
                      for n in KERNELS if hasattr(m, n)]
        for m, n, _ in self.saved:
            setattr(m, n, getattr(kernel_module(n), f"{n}_plain"))

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def lockstep_slice(params, cfg, prompts, steps_tokens, dev):
    """W8A8's phase 4: prefill with the kernels, then each teacher-forced
    decode step from the same cache with the kernels, and with the plain
    entry points on a copy of the cache as it was before the step: as they
    are, and without each quantization point (the controls). Returns per
    step ((hidden, token) of the kernels, (hidden, token) of the plain
    versions, {point: hidden of its control})."""
    import torch

    from physics_llm_inference_tpu_torch.models import transformer as tf
    from physics_llm_inference_tpu_torch.runtime import generate as gen
    from physics_llm_inference_tpu_torch.runtime.kv_cache import KVCache

    ids, lens = gen.pad_and_stack(prompts, device=dev)
    b, p = ids.shape
    cache = KVCache.create(cfg, b, p + len(steps_tokens), dtype=torch.int8,
                           device=dev)
    _, kv, vfrom = gen._prefill(params, cfg, ids, lens, cache.as_slice())

    def step(i, tok, k, v):
        seen = []
        head = tf.lmhead_greedy

        def spy(x, *a, **kw):
            t = head(x, *a, **kw)
            seen.append((x.float().clone(), t.clone()))
            return t

        tf.lmhead_greedy = spy
        try:
            slot = p + i
            tf.forward(params, tok[:, None], cfg, kv=tf.KVSlice(k, v, slot),
                       positions=(lens + i)[:, None],
                       slots=torch.full((b, 1), slot, dtype=torch.int32,
                                        device=dev),
                       valid_from=vfrom, last_only=True, greedy_head=True)
            torch.cuda.synchronize()
        finally:
            tf.lmhead_greedy = head
        return seen[0]

    out = []
    for i, tok in enumerate(steps_tokens):
        was = [t.clone() for t in (kv.k.q, kv.k.s, kv.v.q, kv.v.s)]

        def plain():
            with plain_entry_points():
                return step(i, tok, tf.QuantKV(was[0].clone(), was[1].clone()),
                            tf.QuantKV(was[2].clone(), was[3].clone()))

        got = step(i, tok, kv.k, kv.v)
        want = plain()
        controls = {}
        for point in QUANT_POINTS:
            with quant_point_off(point, cfg.num_layers):
                controls[point] = plain()[0]
        out.append((got, want, controls))
    return out


def slice_parity(dev, fused: bool, mode: str = "w8a16"):
    """Phase 4: kernels vs plain entry points on a 2-layer 7B-width model,
    on the fused decode path in `mode` (FUSED_MODES) or the per-op one."""
    import torch

    from physics_llm_inference_tpu_torch.models import quant
    from physics_llm_inference_tpu_torch.models.config import ModelConfig

    init, act, fused_name, _ = FUSED_MODES[mode]
    cfg = ModelConfig(num_layers=2, fused_decode=fused, act_quant=act,
                      **WIDTHS)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    params = getattr(quant, init)(g, cfg)
    lens = torch.randint(64, PROMPT + 1, (BATCH,), generator=g, device=dev)
    prompts = [torch.randint(1, cfg.vocab_size, (int(n),), generator=g,
                             device=dev).tolist() for n in lens]
    steps = [torch.randint(1, cfg.vocab_size, (BATCH,), generator=g,
                           device=dev) for _ in range(8)]

    path = (("int8_matmul", fused_name, "lmhead_greedy") if fused
            else ("int8_matmul", "int8_kv_decode_attention", "lmhead_greedy"))
    if mode == "w8a8":
        return lockstep_parity(dev, params, cfg, prompts, steps, path)
    before = read_launches()
    logits_k, seen_k = run_slice(params, cfg, prompts, steps, dev)
    after = read_launches()
    used = {n: after[n] - before[n] for n in path}
    if min(used.values()) == 0:
        raise AssertionError(f"slice parity: kernels not all used {used}")
    with plain_entry_points():
        logits_p, seen_p = run_slice(params, cfg, prompts, steps, dev)

    def rel_check(a, b, what):
        # row-wise relative error ||a - b|| / ||b|| (rtol 2e-2): single
        # elements legitimately differ by a bf16 ulp of the residual stream
        # where an int8 KV level or a bf16 rounding flips between the runs
        rel = row_rel(a, b)
        if not bool(torch.isfinite(a).all()) or rel > 2e-2:
            raise AssertionError(f"slice parity {what}: row-wise relative "
                                 f"error {rel:.4g} > 2e-2")
        return rel

    worst = rel_check(logits_k, logits_p, "prefill logits")
    ties, near, eased, close_at = 0, 0, [], 2e-3
    for i, ((xk, tk), (xp, tp)) in enumerate(zip(seen_k, seen_p)):
        worst = max(worst, rel_check(xk, xp, f"step {i} hidden"))
        # the kernel's token must lie within one bf16 ulp of the max of the
        # plain head on the hidden state the kernel run handed it (the head
        # alone), and of the plain run's logits (the path); on a row whose
        # hidden states the two runs round more than 2e-3 apart (W8A8's
        # lockstep threshold), within two ulps of the plain run's max: the
        # plain run's top two logits are then a near-tie within two ulps
        own = ulps_below_max(params, cfg, xk, tk)
        gap = ulps_below_max(params, cfg, xp, tk)
        rel = rows_rel(xk, xp)
        allowed = torch.where(rel > close_at, 2.0, 1.0)
        over = [(r, float(gap[r]), float(rel[r]))
                for r in torch.nonzero(gap > 1).flatten().tolist()]
        if bool((own > 1).any()) or bool((gap > allowed).any()):
            raise AssertionError(
                f"slice parity step {i}: token off the max (kernel run's "
                f"hidden state: {ulp_rows(own, 1)}; plain run's logits, "
                f"(row, ulps, hidden states apart): {over})")
        eased += [f"step {i} row {r} {u:.2f} ulps at hidden {d:.4g}"
                  for r, u, d in over]
        near += int((rel <= close_at).sum())
        ties += int((tk != tp).sum())
    log(f"slice parity, {f'fused {mode.upper()}' if fused else 'per-op'} "
        f"decode (7B widths, 2 layers, B={BATCH}, 8 decode steps): max row-wise "
        f"relative error {worst:.4g} (rtol 2e-2); tokens within one bf16 ulp "
        f"of the max of the plain head on the kernel run's hidden states, and "
        f"of the plain run's logits on every row but {len(eased)} near-ties "
        f"within two ({'; '.join(eased) or 'none'}); {near} of "
        f"{len(seen_k) * BATCH} rows' hidden states within {close_at:g}; "
        f"tokens equal except {ties} bf16 near-ties, kernel launches {used}")


def ulps_below_max(params, cfg, x, tk):
    """Per row, how many bf16 ulps the logit of token `tk` lies below the
    row max of the plain lm_head's logits of the hidden states `x`."""
    import torch

    from physics_llm_inference_tpu_torch.models import transformer as tf

    km = kernel_module("int8_matmul")
    xn = tf.rms_norm(x.bfloat16(), params["norm"], cfg.norm_eps)
    lg = km.int8_matmul_plain(xn, params["lm_head"].q, params["lm_head"].s,
                              out_dtype=torch.float32).bfloat16().float()
    top = lg.max(dim=-1).values
    return (top - lg.gather(1, tk.long()[:, None])[:, 0]) / bf16_ulp(top)


def ulp_rows(ulps, limit: float) -> str:
    """The rows of `ulps` above `limit`, with their ulps."""
    import torch

    rows = torch.nonzero(ulps > limit).flatten().tolist()
    return (f"rows {rows} at {[round(float(ulps[r]), 2) for r in rows]}"
            if rows else f"every row within {limit:g}")


def lockstep_parity(dev, params, cfg, prompts, steps, path):
    """Phase 4 for W8A8 (`lockstep_slice`): each step's hidden state under
    `w8a8_rows_ok`, with its controls. On the rows within 2e-3, at
    least a quarter of all, the kernel's token must be a bf16 max of the
    plain run's logits, as in the other modes; a row moved by a flipped
    activation code may pick another token where the top logits are
    close."""
    before = read_launches()
    pairs = lockstep_slice(params, cfg, prompts, steps, dev)
    after = read_launches()
    used = {n: after[n] - before[n] for n in path}
    if min(used.values()) == 0 or used[path[1]] != len(steps):
        raise AssertionError(f"slice parity W8A8: kernels not used as "
                             f"expected {used}")
    notes, near, differ, close_at = [], 0, 0, 2e-3
    for i, ((xk, tk), (xp, tp), controls) in enumerate(pairs):
        rel = rows_rel(xk, xp)
        notes.append(w8a8_rows_ok(
            rel, {p: rows_rel(c, xp) for p, c in controls.items()},
            f"slice parity W8A8 step {i} hidden"))
        close = rel <= close_at
        if bool((ulps_below_max(params, cfg, xp, tk)[close] > 1).any()):
            raise AssertionError(f"slice parity W8A8 step {i}: token off the "
                                 f"max on a row within {close_at:g}")
        near += int(close.sum())
        differ += int((tk != tp).sum())
    if near < len(pairs) * BATCH // 4:
        raise AssertionError(f"slice parity W8A8: {near} of "
                             f"{len(pairs) * BATCH} rows within "
                             f"{close_at:g}, fewer than a quarter")
    log(f"slice parity, fused W8A8 decode in lockstep (7B widths, 2 layers, "
        f"B={BATCH}, 8 decode steps, each from the kernel run's cache): "
        f"{' | '.join(notes)}; tokens a bf16 max of the plain logits on the "
        f"{near} rows within {close_at:g}; tokens equal except {differ} of "
        f"{len(pairs) * BATCH}; kernel launches {used}")


PAGED_SWAPS = {  # module of the paged path -> the kernel entry points it calls
    "models.paged_transformer": ("flash_attention", "fused_paged_decode_step",
                                 "int8_paged_decode_attention",
                                 "paged_decode_attention"),
    "models.transformer": ("int8_matmul",),
}


def run_paged_slice(params, cfg, prompts, steps, tables, dev):
    """Chunked prefill of the prompts (chunks of 512, as the engine cuts
    them) into fresh INT8 pools in the engine's default geometry (BS 512,
    160 blocks and the trash block), then teacher-forced decode steps at its
    width, with the rows past the prompts inactive on the trash block.
    Returns the prefill logits (n, V) and each step's logits of the prompts'
    rows."""
    import torch

    from physics_llm_inference_tpu_torch.models import paged_transformer as pt
    from physics_llm_inference_tpu_torch.models.transformer import QuantKV

    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    B = tables.shape[0]
    BS, NB = 512, 161
    pools = QuantKV(torch.zeros((L, NB, 2, BS, hkv * hd), dtype=torch.int8,
                                device=dev),
                    torch.zeros((L, NB, 2, hkv, BS), device=dev))
    n = len(prompts)
    plen = torch.tensor([len(p) for p in prompts], device=dev)
    first = torch.zeros((n, cfg.vocab_size), device=dev)
    for start in range(0, int(plen.max()), BS):
        rows = [i for i, p in enumerate(prompts) if len(p) > start]
        ids = torch.zeros((len(rows), BS), dtype=torch.int64, device=dev)
        nval = torch.zeros(len(rows), dtype=torch.int32, device=dev)
        for j, i in enumerate(rows):
            chunk = prompts[i][start:start + BS]
            ids[j, :len(chunk)] = torch.tensor(chunk, device=dev)
            nval[j] = len(chunk)
        idx = torch.tensor(rows, device=dev)
        logits, pools, _ = pt.paged_prefill_chunk_impl(
            params, ids, pools, None, tables[idx],
            torch.full((len(rows),), start, dtype=torch.int32, device=dev),
            nval, cfg)
        done = plen[idx] <= start + BS
        first[idx[done]] = logits[done]
    lens = torch.zeros(B, dtype=torch.int32, device=dev)
    lens[:n] = plen.int()
    seen = []
    for tok in steps:
        logits, pools, _ = pt.paged_decode_step(params, tok, pools, None,
                                                tables, lens, cfg)
        seen.append(logits[:n].clone())
        lens[:n] += 1
    torch.cuda.synchronize()
    return first, seen


def paged_slice_parity(dev):
    """Phase 4, paged: kernels vs plain entry points on a 2-layer 7B-width
    model, 16 requests, in the paged engine's default geometry."""
    import importlib

    import torch

    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import init_params_int8

    cfg = ModelConfig(num_layers=2, **dict(WIDTHS, max_seq_len=1024))
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    params = init_params_int8(g, cfg)
    n, B, MB = 16, 64, 2
    lens = torch.randint(64, 1024 - 16, (n,), generator=g, device=dev)
    lens[:3] = torch.tensor([512, 513, 1000], device=dev)
    prompts = [torch.randint(1, cfg.vocab_size, (int(k),), generator=g,
                             device=dev).tolist() for k in lens]
    perm = torch.randperm(160, generator=g, device=dev)[:n * MB]
    tables = torch.full((B, MB), 160, dtype=torch.int32, device=dev)
    tables[:n] = perm.reshape(n, MB).int()
    steps = []
    for _ in range(8):
        tok = torch.zeros(B, dtype=torch.int64, device=dev)
        tok[:n] = torch.randint(1, cfg.vocab_size, (n,), generator=g,
                                device=dev)
        steps.append(tok)

    reset_launches()
    first_k, seen_k = run_paged_slice(params, cfg, prompts, steps, tables, dev)
    used = read_launches()
    path = ("flash_attention", "fused_paged_decode_step", "int8_matmul")
    if any(used[k] == 0 for k in path) or used["fused_paged_decode_step"] != 8:
        raise AssertionError(f"paged slice parity: kernels not used as "
                             f"expected {used}")
    saved = []
    for mod_name, names in PAGED_SWAPS.items():
        mod = importlib.import_module(f"{PKG}.{mod_name}")
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, getattr(kernel_module(name), f"{name}_plain"))
    try:
        first_p, seen_p = run_paged_slice(params, cfg, prompts, steps, tables,
                                          dev)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    worst, ties = 0.0, 0
    pairs = [("prefill", first_k, first_p)] + [
        (f"step {i}", a, b) for i, (a, b) in enumerate(zip(seen_k, seen_p))]
    for what, a, b in pairs:
        # row-wise relative error (rtol 2e-2): single logits differ by bf16
        # ulps where an int8 level or a bf16 rounding flips between the runs
        rel = row_rel(a, b)
        if not bool(torch.isfinite(a).all()) or rel > 2e-2:
            raise AssertionError(f"paged slice parity, {what}: row-wise "
                                 f"relative error {rel:.4g} > 2e-2")
        worst = max(worst, rel)
        tk, tp = a.argmax(dim=-1), b.argmax(dim=-1)
        # where the tokens differ, the kernel's token is a bf16 max of the
        # plain run's logits
        top = b.max(dim=-1).values
        gap = top - b.gather(1, tk[:, None])[:, 0]
        if bool((gap > bf16_ulp(top)).any()):
            raise AssertionError(f"paged slice parity, {what}: token off the "
                                 "max")
        ties += int((tk != tp).sum())
    log(f"slice parity, paged (7B widths, 2 layers, {n} requests of prompt "
        f"{int(lens.min())}-{int(lens.max())} at decode width {B}, BS=512, "
        f"MB=2; chunked flash prefill, 8 teacher-forced fused paged decode "
        f"steps): max row-wise relative error {worst:.4g} (rtol 2e-2), "
        f"tokens equal except {ties} bf16 near-ties, kernel launches "
        f"{ {k: used[k] for k in path} }")


def kernel_ms(fn) -> float:
    """Device ms of the CUDA kernels fn() runs, by torch.profiler (kernel
    rows only: a host op's device time would count its kernels twice)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        total += (getattr(e, "self_cuda_time_total", 0.0) if us is None
                  else us) / 1e3
    return total


def eager_decode(params, cfg, prompts, fused: bool, steps,
                 new_tokens: int = NEW_TOKENS, kv_dtype="int8"):
    """cached_generate's greedy prefill and decode loop (`new_tokens`
    steps, over a cache of `kv_dtype`, None: the model's dtype) with every
    step of the loop called eagerly, here (no graph): its
    tokens, its decode seconds and, on the per-op path, the host's share of
    a step (wall less the device time of its kernels) for the eager step
    and for a replay of `steps`' captured step."""
    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.ops.sampling import sample_token
    from physics_llm_inference_tpu_torch.runtime import generate as gen

    dev = params["embed"].device
    ids, lens = gen.pad_and_stack(prompts, device=dev)
    b, p = ids.shape
    cap = -(-(p + new_tokens) // 128) * 128
    loop = gen.DecodeLoop(params, cfg, b, cap, kv_dtype, True, 0, False,
                          (), 0, None)
    logits0, _, vfrom = gen._prefill(params, cfg, ids, lens,
                                     loop.cache.as_slice())
    first = sample_token(logits0, None, temperature=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.begin(first, lens, vfrom, p, 0.0, 1.0)
    for _ in range(new_tokens):
        loop.step()
    toks = loop.emitted[:, :new_tokens].cpu().numpy().astype(np.int32)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    host = ""
    if not fused:
        (graph_loop, replay), = [v for v in steps._cache.values()]
        reps = 4
        walls, devs = [], []
        for state, one in ((loop, loop.step), (graph_loop, replay)):
            state.i.zero_()   # steps inside the cache's capacity
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                one()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / reps * 1e3)
            devs.append(kernel_ms(lambda: [one() for _ in range(reps)])
                        / reps)
        host = ("host share of a per-op step (wall less its kernels' "
                "device time, torch.profiler): eager "
                f"{walls[0]:.3f} - {devs[0]:.3f} ms = "
                f"{(walls[0] - devs[0]) / walls[0]:.3f} of the wall, replay "
                f"{walls[1]:.3f} - {devs[1]:.3f} ms = "
                f"{(walls[1] - devs[1]) / walls[1]:.3f}")
    del loop
    return toks, eager_s, host


def full_run(dev, params, prompt: int, fused: bool, layers: int,
             expect, mode: str = "w8a16", readings: dict | None = None
             ) -> dict:
    """Phase 5: one path of the main path at full width, `layers` deep, the
    fused decode in `mode` (FUSED_MODES). Returns the launch counts of its
    timed run; `readings`, if given, gets its replay's ms a step."""
    import torch

    from physics_llm_inference_tpu_torch.bench.headline import \
        speed_of_light_tok_s
    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.runtime.generate import (
        cached_generate, decode_step_cache)
    from physics_llm_inference_tpu_torch.specs.gpu import get_gpu_spec

    _, act, fused_name, wbits = FUSED_MODES[mode]
    cfg = ModelConfig(num_layers=layers, fused_decode=fused, act_quant=act,
                      **WIDTHS)
    g = torch.Generator().manual_seed(SEED + prompt)
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, prompt),
                            generator=g).tolist()
    steps = decode_step_cache()

    def run():
        return cached_generate(params, cfg, prompts, NEW_TOKENS,
                               temperature=0.0, kv_dtype=torch.int8,
                               step_cache=steps)

    t0 = time.perf_counter()
    run()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = run()
    counts = read_launches()
    what = (f"{layers}-layer 7B, prompt {prompt}, "
            f"{f'fused {mode.upper()}' if fused else 'per-op'} decode")
    log(f"{what}: warm-up run {warm:.1f} s; launches during the timed run: "
        f"{counts}")
    missing = [n for n in expect if counts[n] == 0]
    others = [FUSED_MODES[m][2] for m in FUSED_MODES if m != mode]
    if missing or (fused and counts[fused_name] != NEW_TOKENS) or any(
            counts[n] for n in others):
        raise AssertionError(f"{what}: kernels of the path not launched "
                             f"as expected: {counts}")
    if steps.stats() != {"compiled_shapes": 1, "hits": 1, "misses": 1}:
        raise AssertionError(f"{what}: the timed run did not replay the "
                             f"warm run's graph: {steps.stats()}")
    eager_toks, eager_s, host = eager_decode(params, cfg, prompts, fused,
                                             steps)
    if not (eager_toks == out.tokens).all():
        raise AssertionError(f"{what}: graph replay's greedy tokens differ "
                             "from the eager loop's at "
                             f"{int((eager_toks != out.tokens).sum())} places")
    n_tok = BATCH * NEW_TOKENS
    if readings is not None:
        readings["ms_a_step"] = out.decode_s / NEW_TOKENS * 1e3
    log(f"{what}: graph replay {out.decode_s / NEW_TOKENS * 1e3:.3f} ms a "
        f"step, {out.decode_tokens_per_s:.1f} tok/s; eager loop "
        f"{eager_s / NEW_TOKENS * 1e3:.3f} ms a step, "
        f"{n_tok / eager_s:.1f} tok/s; greedy tokens identical; {host}")
    toks = out.tokens
    if toks.shape != (BATCH, NEW_TOKENS) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens: shape {toks.shape}, range "
                             f"[{toks.min()}, {toks.max()}]")

    spec = get_gpu_spec()
    # the weights at their width, as bench.py:120 counts them (INT4: half a
    # byte a parameter; scales left out)
    floor_s = BATCH / speed_of_light_tok_s(cfg, BATCH, prompt, NEW_TOKENS,
                                           wbits, spec)
    tok_s = out.decode_tokens_per_s
    share = tok_s * floor_s / BATCH
    log(f"{what} (B={BATCH}, {NEW_TOKENS} greedy tokens, "
        f"{mode.upper()} with INT8 KV): "
        f"prefill (TTFT) {out.prefill_s * 1e3:.1f} ms, decode "
        f"{out.decode_s * 1e3:.1f} ms, {tok_s:.1f} tok/s, "
        f"{out.time_per_output_token_s * 1e3:.2f} ms/step; HBM floor "
        f"{floor_s * 1e6:.0f} us/step on {spec.name} spec "
        f"({spec.hbm_gbps:.0f} GB/s) -> share {share:.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return counts


def decode_alone(dev):
    """--decode: phase 5's cached_generate at prompt 128 in each K4 mode
    and on the per-op path, 32 layers, each a warm-up run, a timed run and
    the eager loop."""
    import torch

    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import (init_params_int4,
                                                              init_params_int8)

    cfg = ModelConfig(num_layers=32, **WIDTHS)
    for mode, (init, _, name, _) in FUSED_MODES.items():
        init_fn = {"init_params_int8": init_params_int8,
                   "init_params_int4": init_params_int4}[init]
        params = init_fn(torch.Generator(device=dev).manual_seed(SEED), cfg)
        full_run(dev, params, PROMPT, True, 32,
                 ("int8_matmul", name, "lmhead_greedy"), mode=mode)
        if mode == "w8a16":
            full_run(dev, params, PROMPT, False, 32,
                     ("int8_matmul", "int8_kv_decode_attention",
                      "lmhead_greedy"))
        del params
        torch.cuda.empty_cache()


def sampled_run(dev, params, cfg):
    """cached_generate sampled (temperature 0.8, top-k 50, top-p 0.9) with
    a new caller's generator from one seed, twice through one step cache:
    which form its decode loop ran in (a CUDA graph with the loop's own
    generator registered, or eager), the second call replaying the first
    one's entry, and the two runs' tokens and the callers' generator states
    after them equal."""
    import torch

    from physics_llm_inference_tpu_torch.runtime.generate import (
        cached_generate, decode_step_cache)
    from physics_llm_inference_tpu_torch.runtime.step_cache import \
        CapturedStep

    g = torch.Generator().manual_seed(SEED + 5)
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, PROMPT),
                            generator=g).tolist()
    steps = decode_step_cache()
    outs, states = [], []
    for _ in range(2):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        outs.append(cached_generate(params, cfg, prompts, 16, generator=gen,
                                    temperature=0.8, top_k=50, top_p=0.9,
                                    kv_dtype=torch.int8, step_cache=steps))
        states.append(gen.get_state())
    captured = all(isinstance(step, CapturedStep)
                   for _, step in steps._cache.values())
    same = bool((outs[0].tokens == outs[1].tokens).all())
    hit = steps.stats() == {"compiled_shapes": 1, "hits": 1, "misses": 1}
    log(f"sampled cached_generate (B={BATCH}, prompt {PROMPT}, 16 tokens, "
        "T 0.8, top-k 50, top-p 0.9): its decode loop ran "
        + ("as a CUDA graph with its generator registered"
           if captured else "eagerly")
        + f"; the second caller's generator replayed the first one's entry: "
        f"{hit}; two runs from one seed give equal tokens: {same}; decode "
        f"{outs[1].decode_s / 16 * 1e3:.3f} ms a step, "
        f"{outs[1].decode_tokens_per_s:.1f} tok/s")
    if not (same and hit and torch.equal(*states)):
        raise AssertionError("sampled cached_generate: two runs from one "
                             f"seed differ (tokens equal {same}, cache hit "
                             f"{hit}, generator states equal "
                             f"{torch.equal(*states)})")


def full_runs(dev):
    """Phase 5: the default config at prompt 128 and 512, then the per-op
    decode path, then W8A8 and W4A16 at prompt 128. Returns each kernel's
    launches summed over the timed runs, the INT8 parameters and the
    default decode's ms a step at prompt 128."""
    import torch

    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import (
        init_params_int4, init_params_int8, quantized_param_bytes)

    cfg = ModelConfig(num_layers=32, **WIDTHS)
    t0 = time.perf_counter()
    params = init_params_int8(torch.Generator(device=dev).manual_seed(SEED),
                              cfg)
    torch.cuda.synchronize()
    log(f"7B init on the card: {cfg.param_count() / 1e9:.2f}B params, "
        f"{time.perf_counter() - t0:.1f} s")
    fused = ("int8_matmul", "fused_decode_step", "lmhead_greedy")
    readings = {}
    runs = [full_run(dev, params, PROMPT, True, 32, fused,
                     readings=readings),
            full_run(dev, params, LONG_PROMPT, True, 32,
                     fused + ("flash_attention",)),
            full_run(dev, params, PROMPT, False, 32,
                     ("int8_matmul", "int8_kv_decode_attention",
                      "lmhead_greedy")),
            # W8A8: the same INT8 weights, activations quantized in K4
            full_run(dev, params, PROMPT, True, 32,
                     ("int8_matmul", "fused_decode_step_w8a8",
                      "lmhead_greedy"), mode="w8a8")]
    sampled_run(dev, params, cfg)
    # W4A16: INT4 block weights (the lm_head int8), prefill linears
    # dequantized into a library GEMM, K1 on the lm_head, K3, K4 W4A16
    t0 = time.perf_counter()
    p4 = init_params_int4(torch.Generator(device=dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    log(f"7B INT4 init on the card: {time.perf_counter() - t0:.1f} s, "
        f"{quantized_param_bytes(p4)}")
    runs.append(full_run(dev, p4, PROMPT, True, 32,
                         ("int8_matmul", "fused_decode_step_w4a16",
                          "lmhead_greedy"), mode="w4a16"))
    del p4
    torch.cuda.empty_cache()
    # bench.py's protocol on the card in its default configuration (W8A16)
    from physics_llm_inference_tpu_torch.bench import headline

    t0 = time.perf_counter()
    res = headline.main()
    torch.cuda.empty_cache()
    log(f"bench/headline.main(): {json.dumps(res)} ({nvidia_smi()}; "
        f"{time.perf_counter() - t0:.1f} s with its 7B init)")
    return ({n: sum(r[n] for r in runs) for n in KERNELS}, params,
            readings["ms_a_step"])


class CallTime:
    """Device time of every call of `module.name` inside the block: a CUDA
    event pair recorded on the stream around each call, read at the end. It
    bounds the call's kernels from above: a pair also holds any time the
    device waits for the host between the two records."""

    def __init__(self, module, name: str):
        self.module, self.name, self.pairs = module, name, []

    def __enter__(self):
        import torch

        self.fn = getattr(self.module, self.name)

        def spy(*a, **kw):
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
            out = self.fn(*a, **kw)
            pair[1].record()
            self.pairs.append(pair)
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


class K1Census:
    """K1's launches inside the block by route and row count M: a spy on
    the name models/transformer._linear calls (every K1 call of the model
    goes through it), keyed on the route whose launch counter the call
    moved."""

    def __init__(self):
        from physics_llm_inference_tpu_torch.models import transformer

        self.module, self.seen = transformer, {}

    def __enter__(self):
        from physics_llm_inference_tpu_torch.kernels import int8_matmul as km

        self.fn = self.module.int8_matmul

        def counts():
            return [getattr(km, f"{r}_launches") for r in km.ROUTES]

        def spy(x, w, s, *a, **kw):
            before = counts()
            out = self.fn(x, w, s, *a, **kw)
            moved = [r for r, b, c in zip(km.ROUTES, before, counts())
                     if c != b]
            key = (moved[0] if len(moved) == 1 else f"launched {moved}",
                   x.shape[0], w.shape[-1])
            self.seen[key] = self.seen.get(key, 0) + 1
            return out

        self.module.int8_matmul = spy
        return self

    def __exit__(self, *exc):
        self.module.int8_matmul = self.fn

    def report(self) -> str:
        by = {}
        for (r, m, n), c in self.seen.items():
            by[r, m] = by.get((r, m), 0) + c
        return ", ".join(f"{r} M={m}: {c}" for (r, m), c in
                         sorted(by.items(), key=lambda kv: kv[0][1]))

    def launched(self, route: str, n: int | None = None) -> bool:
        """Whether `route` took a call (with N = n, if given)."""
        return any(r == route and n in (None, nn)
                   for r, _, nn in self.seen)


def profile_wave(run, what: str, wall_s: float):
    """One wave under torch.profiler: device ms by kernel (the ten largest,
    K1's kernels apart); their sum over `wall_s`, the unprofiled wall of a
    wave like it, is the kernels' share of the wall (the profiler itself
    slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue   # a host op: its kernels are rows of their own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    k1 = [r for r in rows if "int8_matmul" in r[2] or "splitk" in r[2]]
    log(f"{what}, profiled wave: wall {wall:.3f} s (profiler on); kernels "
        f"{total:.1f} ms of device time, {total / 1e3 / wall_s:.4f} of the "
        f"measured wave's {wall_s:.3f} s; K1 {sum(r[0] for r in k1):.1f} ms "
        f"over {sum(r[1] for r in k1)} kernel launches ("
        + "; ".join(f"{name[:60]} {ms:.1f} ms x {c}" for ms, c, name in k1)
        + "); largest: "
        + "; ".join(f"{name[:60]} {ms:.1f} ms x {c}"
                    for ms, c, name in rows[:10]))


def eager_engine_class():
    """PagedInferenceEngine with its two dispatch functions called eagerly,
    here, not through a switch in the package: the prefill chunk and the
    decode horizon as plain calls of the model functions on fresh device
    tensors, with no graph."""
    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.models.paged_transformer import (
        paged_decode_scan_impl, paged_prefill_chunk_impl)
    from physics_llm_inference_tpu_torch.serve.paged_engine import \
        PagedInferenceEngine

    class EagerEngine(PagedInferenceEngine):
        def _t(self, a):
            return torch.tensor(np.asarray(a), device=self.device)

        def _prefill(self, ids, tables, starts, nval):
            logits, self._k, self._v = paged_prefill_chunk_impl(
                self.params, self._t(ids), self._k, self._v, self._t(tables),
                self._t(starts), self._t(nval), self.cfg)
            return logits

        def _decode(self, horizon, filtered, tokens, tables, temps, top_ks,
                    top_ps):
            toks, self._k, self._v = paged_decode_scan_impl(
                self.params, self._t(tokens), self._k, self._v,
                self._t(tables), self._t(self._lengths), self._rng,
                self._t(temps), self._t(top_ps), self.cfg, horizon=horizon,
                top_ks=self._t(top_ks), filtered=filtered)
            return toks.cpu().numpy()

    return EagerEngine


def serve(dev, params, cfg, what: str, kw: dict, n: int, prompt: int,
          tokens: int, expect, forbid, shared: bool = False,
          warm: int = 0, waves: int = 1, compare: bool = False,
          profiled: bool = False) -> dict:
    """Phase 5, paged: one PagedInferenceEngine (its dispatch steps captured
    as CUDA graphs by `warmup()` and at first use) serving `waves` waves of
    n greedy requests, each submitted at once and run to the end, each
    after a warm wave of `warm` requests (16 tokens each, not measured).
    Every measured wave repeats one workload: the radix cache is emptied
    (its blocks back to the pool) before each warm wave, and the warm and
    the measured waves draw the same prompts each time. With
    `shared`, every fourth prompt starts with one of SHARED_PREFIXES
    block-sized prefixes, as in scripts/bench_serving7b.py. With `compare`,
    the same request stream goes through the engine with eager dispatch
    functions (eager_engine_class) too: tokens, finish reasons and each
    wave's dispatch_trace must be identical; K1's launches are counted by
    route and M over the eager waves (a replay calls no Python). With
    `profiled`, one more wave of the captured engine runs under
    torch.profiler. Returns the launch counts summed over the captured
    engine's measured waves."""
    import contextlib
    import gc

    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.models import \
        paged_transformer as paged_model
    from physics_llm_inference_tpu_torch.serve.engine import GenerationRequest
    from physics_llm_inference_tpu_torch.serve.paged_engine import (
        PagedEngineConfig, PagedInferenceEngine)

    pc = PagedEngineConfig(**kw)
    engines = [("captured", PagedInferenceEngine)]
    if compare:
        engines.append(("eager", eager_engine_class()))
    seen, total = {}, {k: 0 for k in KERNELS}
    for label, cls in engines:
        eng = cls(params, cfg, pc)
        t0 = time.perf_counter()
        eng.warmup()
        setup_s = time.perf_counter() - t0
        rng = np.random.default_rng(SEED)
        prefixes = [rng.integers(1, cfg.vocab_size, pc.block_size).tolist()
                    for _ in range(SHARED_PREFIXES)]

        def wave(count, max_tokens, seed):
            rng = np.random.default_rng(seed)
            rids = []
            for i in range(count):
                pre = (prefixes[(i // 4) % SHARED_PREFIXES]
                       if shared and i % 4 == 0 else [])
                p = pre + rng.integers(1, cfg.vocab_size,
                                       prompt - len(pre)).tolist()
                rids.append(eng.submit_request(GenerationRequest(
                    prompt_tokens=p, max_tokens=max_tokens,
                    temperature=0.0)))
            eng.run_until_done(rids)
            torch.cuda.synchronize()
            return rids

        def warm_wave():
            """Empty the radix cache, then the warm wave: the state every
            measured wave starts from."""
            if eng.radix is not None:
                eng._radix_evict(eng.radix.total_cached_tokens())
                if eng.radix.total_cached_tokens():
                    raise AssertionError(f"{what}: the radix cache kept "
                                         f"{eng.radix.total_cached_tokens()}"
                                         " tokens after evicting them all")
            if warm:
                wave(warm, 16, SEED + 1)

        # host time of the prefill and decode dispatches, each ended by a
        # synchronize (both already wait for the device: the tokens come
        # back)
        spent = {"prefill": 0.0, "decode": 0.0}

        def timed(kind, fn):
            def run(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                spent[kind] += time.perf_counter() - t
                return out
            run.__wrapped__ = fn
            return run

        eng._prefill = timed("prefill", eng._prefill)
        eng._decode = timed("decode", eng._decode)
        torch.cuda.reset_peak_memory_stats()
        walls, spents, lines, warm_s = [], [], [], []
        seen[label] = []
        for _ in range(waves):
            t0 = time.perf_counter()
            warm_wave()
            warm_s.append(time.perf_counter() - t0)
            hits0 = eng.stats()["radix_hit_tokens"]
            pre0 = eng.scheduler.num_preempted
            for k in spent:
                spent[k] = 0.0
            eng.dispatch_trace = []
            reset_launches()
            t0 = time.perf_counter()
            # K5's event pairs and K1's census wrap Python calls: only the
            # eager engine makes them (a replay calls no Python)
            eager = label == "eager"
            with (CallTime(paged_model, "flash_attention") if eager
                  else contextlib.nullcontext()) as k5, \
                    (K1Census() if eager else contextlib.nullcontext()) as k1:
                rids = wave(n, tokens, SEED + 2)
            wall = time.perf_counter() - t0
            counts = read_launches()
            res = [eng.get_result(r) for r in rids]
            seen[label].append(([(r.tokens, r.finish_reason) for r in res],
                                list(eng.dispatch_trace)))
            bad = [r.request_id for r in res if len(r.tokens) != tokens
                   or min(r.tokens) < 0 or max(r.tokens) >= cfg.vocab_size]
            if bad:
                raise AssertionError(f"{what}, {label}: requests with wrong "
                                     f"tokens: {bad[:5]}")
            steps = sum(t[1] for t in eng.dispatch_trace if t[0] == "decode")
            missing = [k for k in expect if counts[k] == 0]
            wrong = [k for k in forbid if counts[k] != 0]
            if missing or wrong or ("fused_paged_decode_step" in expect
                                    and counts["fused_paged_decode_step"]
                                    != steps):
                raise AssertionError(f"{what}, {label}: kernels not launched "
                                     f"as expected ({steps} decode steps): "
                                     f"{counts}")
            # K1: the prefill chunks through wgmma, the decode head through
            # the stream (counted where the dispatches run in Python)
            if eager and "int8_matmul_prefill" in expect and not (
                    k1.launched("wgmma")
                    and k1.launched("stream", cfg.vocab_size)):
                raise AssertionError(f"{what}: K1 routes {k1.report()}")
            if label == "captured":
                total = {k: total[k] + counts[k] for k in KERNELS}
            ttft = sorted(r.ttft_s for r in res)
            hits = eng.stats()["radix_hit_tokens"] - hits0
            preempt = eng.scheduler.num_preempted - pre0
            if shared and hits <= 0:
                raise AssertionError(f"{what}: no radix hit")
            prefills = sum(1 for t in eng.dispatch_trace
                           if t[0] == "prefill")
            walls.append(wall)
            spents.append(dict(spent))
            lines.append(
                f"wall {wall:.3f} s, {n * tokens / wall:.1f} output tok/s, "
                f"{n / wall:.2f} requests/s, TTFT p50 "
                f"{ttft[len(ttft) // 2] * 1e3:.1f} ms p90 "
                f"{ttft[int(len(ttft) * 0.9)] * 1e3:.1f} ms; radix_hit_tokens"
                f" {hits}, preemptions {preempt}; {prefills} prefill and "
                f"{len(eng.dispatch_trace) - prefills} decode dispatches, "
                f"{steps} decode steps; prefill dispatches "
                f"{spent['prefill']:.3f} s, decode dispatches "
                f"{spent['decode']:.3f} s, the rest "
                f"{wall - sum(spent.values()):.3f} s; launches "
                f"{ {k: v for k, v in counts.items() if v} }"
                + (f"; K5 (event pairs around its calls) {k5.ms():.1f} ms; "
                   f"K1 by route and M: {k1.report()}" if eager else ""))
        mid = sorted(range(waves), key=lambda i: walls[i])[waves // 2]
        log(f"{what}, {label} dispatch: {n} requests x prompt {prompt} -> "
            f"{tokens} greedy tokens"
            f"{', every 4th behind a shared prefix' if shared else ''}; "
            f"warmup() {setup_s:.1f} s "
            f"(prefill_compile {eng.stats().get('prefill_compile')}), warm "
            f"waves {warm} requests "
            f"{', '.join(f'{t:.1f}' for t in warm_s)} s; radix cache "
            f"{type(eng.radix).__name__ if eng.radix else 'off'}; median "
            f"wall of {waves}: {walls[mid]:.3f} s (prefill dispatches "
            f"{spents[mid]['prefill']:.3f} s, decode dispatches "
            f"{spents[mid]['decode']:.3f} s); peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; waves: "
            + " | ".join(lines))
        if profiled and label == "captured":
            eng._prefill, eng._decode = eng._prefill.__wrapped__, \
                eng._decode.__wrapped__
            warm_wave()
            profile_wave(lambda: wave(n, tokens, SEED + 2), what, walls[mid])
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    if compare:
        for i, (a, b) in enumerate(zip(seen["captured"], seen["eager"])):
            if a[0] != b[0]:
                raise AssertionError(f"{what}, wave {i}: tokens or finish "
                                     "reasons of the captured engine differ "
                                     "from the eager engine's")
            if a[1] != b[1]:
                j = next((k for k, (u, v) in enumerate(zip(a[1], b[1]))
                          if u != v), min(len(a[1]), len(b[1])))
                raise AssertionError(
                    f"{what}, wave {i}: dispatch_trace of the captured "
                    f"engine differs from the eager engine's at entry {j} "
                    f"of {len(a[1])}/{len(b[1])}: "
                    f"{a[1][j] if j < len(a[1]) else None} against "
                    f"{b[1][j] if j < len(b[1]) else None}; host clock "
                    f"{time.get_clock_info('monotonic')}")
        log(f"{what}: the captured and the eager engine gave identical "
            f"tokens, finish reasons and dispatch_trace in {waves} waves")
    return total


def serving_cfg():
    from physics_llm_inference_tpu_torch.models.config import ModelConfig

    return ModelConfig(num_layers=32, **dict(WIDTHS, max_seq_len=1024))


def bench_wave(dev, params, cfg) -> dict:
    """The paged engine in the bench_serving7b configuration (K8 decode, K5
    prefill, K1 on both routes), a profiled wave after the measured one."""
    return serve(dev, params, cfg, "paged engine, bench_serving7b "
                 "configuration", dict(max_batch=64, kv_dtype="int8",
                                       decode_horizon=8, enable_radix=True,
                                       prefill_tokens_per_iter=2048),
                 SERVE_REQUESTS, SERVE_PROMPT, SERVE_TOKENS,
                 expect=("fused_paged_decode_step", "flash_attention",
                         "int8_matmul", "int8_matmul_prefill"),
                 forbid=("int8_paged_decode_attention",
                         "paged_decode_attention"), shared=True, warm=64,
                 waves=3, compare=True, profiled=True)


def serving_runs(dev, params) -> dict:
    """Phase 5, paged: the bench_serving7b configuration (K8 decode, K5
    prefill), then the per-op routes at full width with fewer requests:
    INT8 pools at block size 16 (K6) and bf16 pools (K7). Returns each
    kernel's launches summed over the measured waves."""
    cfg = serving_cfg()
    small = dict(max_batch=64, block_size=16, max_blocks_per_request=64,
                 num_blocks=64 * 64 + 16, decode_horizon=8,
                 prefill_tokens_per_iter=2048)
    runs = [
        bench_wave(dev, params, cfg),
        serve(dev, params, cfg, "paged engine, per-op route, INT8 pools, "
              "BS=16", dict(small, kv_dtype="int8"), 64, 128, 16,
              expect=("int8_paged_decode_attention", "flash_attention",
                      "int8_matmul"), forbid=("fused_paged_decode_step",)),
        serve(dev, params, cfg, "paged engine, per-op route, bf16 pools, "
              "BS=16", dict(small, kv_dtype=None), 64, 128, 16,
              expect=("paged_decode_attention", "flash_attention",
                      "int8_matmul"),
              forbid=("fused_paged_decode_step",
                      "int8_paged_decode_attention")),
    ]
    return {k: sum(r[k] for r in runs) for k in KERNELS}


# phase 5c, the serving front end: the slot engine behind the HTTP server
FRONT_REQUESTS, FRONT_CLIENTS, FRONT_TOKENS = 128, 32, 64
FRONT_PROMPTS = (32, 576)          # prompt tokens, drawn from a seed
FRONT_TIMEOUT = 300                # seconds a client waits for a response


class CodepointTokenizer:
    """Each character is its code point: injective over the 7B vocab, so a
    response's text gives back its tokens, and a prompt's text is its
    tokens."""

    def encode(self, text: str) -> list[int]:
        return [ord(c) for c in text]

    def decode(self, ids) -> str:
        return "".join(chr(int(i)) for i in ids)


def eager_slot_engine_class():
    """InferenceEngine with its three dispatch functions called eagerly,
    here, not through a switch in the package: the prefill chunk straight
    into the pool's (L, 1, S, ·) view of the slot (no slot buffer), the
    decode horizon and the verify window as plain calls of the step
    functions on fresh device tensors, with no graph."""
    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.runtime.speculative import \
        _verify_window
    from physics_llm_inference_tpu_torch.serve.engine import (
        InferenceEngine, _slot_of_cache, decode_horizon, prefill_chunk)

    class EagerSlotEngine(InferenceEngine):
        def _t(self, a):
            return torch.tensor(np.asarray(a), device=self.device)

        def _prefill(self, slot, ids, pos, n, sampling):
            return prefill_chunk(
                self.params, self.cfg, self._t(ids),
                _slot_of_cache(self._k, slot), _slot_of_cache(self._v, slot),
                self._t(pos), self._t(n), self._rng,
                self._t(np.float32(sampling.temperature)),
                self._t(np.full(1, sampling.top_k, np.int32)),
                self._t(np.float32(sampling.top_p)))

        def _decode(self, horizon, filtered, tokens, lens, temps, top_ks,
                    top_ps):
            return decode_horizon(
                self.params, self.cfg, self._k, self._v, self._t(tokens),
                self._t(lens), self._rng, self._t(temps), self._t(top_ks),
                self._t(top_ps), horizon, filtered).cpu().numpy()

        def _verify(self, window, starts):
            starts = self._t(starts)
            return _verify_window(self.params, self.cfg, self._t(window),
                                  self._k, self._v, starts, starts,
                                  None).cpu().numpy()

    return EagerSlotEngine


def front_contents(seed: int, n: int, lo: int, hi: int, vocab: int):
    """n chat contents whose prompts ("user: " + content, one token a
    character) have lengths drawn in [lo, hi]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    return ["".join(chr(int(c)) for c in rng.integers(1, vocab, int(m) - 6))
            for m in lens]


def prompt_tokens(content: str) -> list[int]:
    """The prompt the server makes of a one-message chat."""
    return CodepointTokenizer().encode(f"user: {content}")


def chat(port: int, content: str, max_tokens: int, stream: bool):
    """One greedy chat request; returns (tokens, finish_reason) read back
    from the response's text (SSE deltas joined when streaming)."""
    import urllib.request

    body = json.dumps({"messages": [{"role": "user", "content": content}],
                       "max_tokens": max_tokens, "temperature": 0.0,
                       "stream": stream}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=FRONT_TIMEOUT) as r:
        if not stream:
            d = json.load(r)
            text = d["choices"][0]["message"]["content"]
            reason = d["choices"][0]["finish_reason"]
            if d["usage"]["completion_tokens"] != len(text):
                raise AssertionError(f"usage {d['usage']} against "
                                     f"{len(text)} characters")
        else:
            events = [e[6:] for e in r.read().decode().split("\n\n")
                      if e.startswith("data: ")]
            if events[-1] != "[DONE]":
                raise AssertionError(f"SSE ended with {events[-1][:80]}")
            chunks = [json.loads(e) for e in events[:-1]]
            text = "".join(c["choices"][0]["delta"].get("content", "")
                           for c in chunks)
            reason = chunks[-1]["choices"][0]["finish_reason"]
    return CodepointTokenizer().encode(text), reason


def client_wave(eng, contents, clients: int, max_tokens: int, what: str,
                http: bool = True, during=None):
    """`clients` client threads send every request of `contents`, each its
    share in turn, waiting for one response before the next: with `http`,
    as chat requests to the engine behind InferenceServer(port=0) on
    127.0.0.1 with the code point tokenizer, every fourth streamed over SSE;
    else straight to the engine (submit_request, then wait_result) under a
    ServingLoop. Then `during(eng, server)`, the server still up. Returns
    the (tokens, finish_reason) of each request in `contents`' order, the
    wall from the first request to the last response, and the engine's
    TTFTs of the wave."""
    import threading

    from physics_llm_inference_tpu_torch.serve.engine import GenerationRequest
    from physics_llm_inference_tpu_torch.serve.http_server import (
        InferenceServer, ServingLoop)
    from physics_llm_inference_tpu_torch.serve.tokenizer_pool import \
        TokenizerPool

    n = len(contents)
    before = set(eng._results)
    got, errors = [None] * n, []
    if http:
        srv = InferenceServer(eng, port=0, tokenizer=TokenizerPool(
            num_workers=4, tokenizer_factory=CodepointTokenizer))
        srv.start_background()
        loop = srv.loop

        def send(i):
            return chat(srv.port, contents[i], max_tokens, stream=i % 4 == 0)
    else:
        srv, loop = None, ServingLoop(eng)

        def send(i):
            rid = eng.submit_request(GenerationRequest(
                prompt_tokens=prompt_tokens(contents[i]),
                max_tokens=max_tokens, temperature=0.0))
            loop.notify()
            res = eng.wait_result(rid, timeout=FRONT_TIMEOUT)
            return res.tokens, res.finish_reason
    try:
        def client(c):
            for i in range(c, n, clients):
                try:
                    got[i] = send(i)
                except Exception as e:  # reported below, with the others
                    errors.append(f"request {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(FRONT_TIMEOUT)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads) or None in got:
            raise AssertionError(f"{what}: {len(errors)} requests failed "
                                 f"(loop thread alive: "
                                 f"{loop._thread.is_alive()}): "
                                 f"{errors[:3]}")
        if during is not None:
            during(eng, srv)
    finally:
        if srv is not None:
            srv.shutdown()
        else:
            loop.shutdown()
    if loop._thread.is_alive():
        raise AssertionError(f"{what}: the serving loop did not stop")
    ttft = sorted(r.ttft_s for k, r in eng._results.items()
                  if k not in before and r.ttft_s is not None)
    return got, wall, ttft


def direct_run(eng, prompts, max_tokens: int):
    """Every prompt submitted to the engine at once, run to the end on this
    thread. Returns (results, dispatch_trace, wall)."""
    import torch

    from physics_llm_inference_tpu_torch.serve.engine import GenerationRequest

    eng.dispatch_trace = []
    t0 = time.perf_counter()
    rids = [eng.submit_request(GenerationRequest(
        prompt_tokens=p, max_tokens=max_tokens, temperature=0.0))
        for p in prompts]
    eng.run_until_done(rids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([eng.get_result(r) for r in rids], list(eng.dispatch_trace),
            wall)


def same_run(a, b, what: str) -> None:
    """Two direct runs' tokens, finish reasons and dispatch traces equal."""
    (ra, ta, _), (rb, tb, _) = a, b
    if [(r.tokens, r.finish_reason) for r in ra] != \
            [(r.tokens, r.finish_reason) for r in rb]:
        bad = [i for i, (x, y) in enumerate(zip(ra, rb))
               if (x.tokens, x.finish_reason) != (y.tokens, y.finish_reason)]
        raise AssertionError(f"{what}: tokens or finish reasons differ at "
                             f"requests {bad[:8]} of {len(ra)}")
    if ta != tb:
        j = next((k for k, (u, v) in enumerate(zip(ta, tb)) if u != v),
                 min(len(ta), len(tb)))
        raise AssertionError(f"{what}: dispatch_trace differs at entry {j} "
                             f"of {len(ta)}/{len(tb)}")


def pct(vals, q: float) -> float:
    return vals[min(len(vals) - 1, int(len(vals) * q))]


def full_horizon_ms(eng, cfg) -> list:
    """ms a step of each decode dispatch with every slot decoding at the
    full horizon: num_slots requests of prompt 128 for 64 tokens, each
    dispatch ended by its tokens' read-back."""
    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.serve.engine import GenerationRequest

    c = eng.config
    rng = np.random.default_rng(SEED + 11)
    decode, seen = eng._decode, []

    def timed(h, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode(h, *a)
        seen.append((h, len(eng.dispatch_trace[-1][3]),
                     (time.perf_counter() - t) * 1e3 / h))
        return out

    eng._decode = timed
    eng.dispatch_trace = []
    try:
        rids = [eng.submit_request(GenerationRequest(
            prompt_tokens=rng.integers(1, cfg.vocab_size, 128).tolist(),
            max_tokens=64, temperature=0.0)) for _ in range(c.num_slots)]
        eng.run_until_done(rids)
    finally:
        del eng._decode
    return [ms for h, rows, ms in seen
            if h == c.decode_horizon and rows == c.num_slots]


def slot_frontend(dev, params, cfg, step_ms) -> dict:
    """Phase 5c, slot engine: warmup() on this thread, then the HTTP wave
    (K1, K4 and K5 launched, K4 once a decode step), the same requests
    submitted directly (the HTTP wall against the direct one), a full
    64-slot horizon's ms a step, then the engine with eager dispatch
    functions on the same requests: tokens, finish reasons and
    dispatch_trace identical to the captured engine's direct run, and every
    HTTP response's tokens equal to the eager engine's for its request.
    Returns the HTTP wave's launch counts."""
    import gc

    import torch

    from physics_llm_inference_tpu_torch.serve.engine import (EngineConfig,
                                                              InferenceEngine)

    what = "front end, slot engine"
    kw = dict(num_slots=64, max_seq_len=1024, kv_dtype="int8",
              decode_horizon=8)
    contents = front_contents(SEED + 9, FRONT_REQUESTS, *FRONT_PROMPTS,
                              cfg.vocab_size)
    prompts = [prompt_tokens(c) for c in contents]
    eng = InferenceEngine(params, cfg, EngineConfig(**kw))
    setup_s = eng.warmup()
    direct = direct_run(eng, prompts, FRONT_TOKENS)
    eng.dispatch_trace = []
    reset_launches()
    got, wall, ttft = client_wave(eng, contents, FRONT_CLIENTS, FRONT_TOKENS,
                                  what)
    counts = read_launches()
    steps = sum(t[1] for t in eng.dispatch_trace if t[0] == "decode")
    chunks = [t for t in eng.dispatch_trace if t[0] == "prefill"]
    eng.dispatch_trace = []
    closed, closed_wall, closed_ttft = client_wave(
        eng, contents, FRONT_CLIENTS, FRONT_TOKENS, what, http=False)
    closed_steps = sum(t[1] for t in eng.dispatch_trace if t[0] == "decode")
    direct_steps = sum(t[1] for t in direct[1] if t[0] == "decode")
    missing = [k for k in ("int8_matmul", "int8_matmul_prefill",
                           "fused_decode_step", "flash_attention")
               if counts[k] == 0]
    wrong = [k for k in ("int8_kv_decode_attention", "lmhead_greedy",
                         "fused_paged_decode_step") if counts[k]]
    if missing or wrong or counts["fused_decode_step"] != steps:
        raise AssertionError(f"{what}: kernels not launched as expected "
                             f"({steps} decode steps): {counts}")
    full = full_horizon_ms(eng, cfg)
    if not full:
        raise AssertionError(f"{what}: no full-horizon dispatch")
    stats = eng.stats()
    json.dumps(stats)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    eager = eager_slot_engine_class()(params, cfg, EngineConfig(**kw))
    plain = direct_run(eager, prompts, FRONT_TOKENS)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    same_run(direct, plain, f"{what}: captured against eager dispatch")
    want = [(r.tokens, r.finish_reason) for r in plain[0]]
    if closed != want:
        raise AssertionError(f"{what}: the closed-loop direct wave's tokens "
                             "differ from the eager engine's")
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad:
        i = bad[0]
        pos = next((j for j, (a, b) in enumerate(zip(got[i][0], want[i][0]))
                    if a != b), None)
        raise AssertionError(f"{what}: {len(bad)} HTTP responses differ from "
                             f"the eager engine's tokens (request {i}, "
                             f"first at position {pos}, finish "
                             f"{got[i][1]}/{want[i][1]})")
    if any(len(t) != FRONT_TOKENS for t, _ in got):
        raise AssertionError(f"{what}: a response without {FRONT_TOKENS} "
                             "tokens")
    n_tok = FRONT_REQUESTS * FRONT_TOKENS
    full.sort()
    log(f"{what} ({nvidia_smi()}): 64 slots x 1,024 positions, INT8 pool, "
        f"horizon 8; warmup() {setup_s:.1f} s (prefill_compile "
        f"{stats['prefill_compile']}); HTTP wave of {FRONT_REQUESTS} chat "
        f"requests from {FRONT_CLIENTS} client threads (every 4th SSE), "
        f"prompts {FRONT_PROMPTS[0]}-{FRONT_PROMPTS[1]}, {FRONT_TOKENS} "
        f"greedy tokens: wall {wall:.3f} s, {FRONT_REQUESTS / wall:.2f} "
        f"requests/s, {n_tok / wall:.1f} output tok/s, TTFT p50 "
        f"{pct(ttft, 0.5) * 1e3:.1f} ms p90 {pct(ttft, 0.9) * 1e3:.1f} ms; "
        f"{len(chunks)} prefill chunks, {steps} decode steps; the same "
        f"requests from {FRONT_CLIENTS} threads straight to the engine (no "
        f"HTTP): wall {closed_wall:.3f} s, {n_tok / closed_wall:.1f} tok/s, "
        f"TTFT p50 {pct(closed_ttft, 0.5) * 1e3:.1f} ms p90 "
        f"{pct(closed_ttft, 0.9) * 1e3:.1f} ms, {closed_steps} decode steps; "
        f"all submitted at once: wall {direct[2]:.3f} s "
        f"({n_tok / direct[2]:.1f} tok/s, {direct_steps} decode steps), "
        f"eager dispatch {plain[2]:.3f} s; "
        f"full 64-slot horizon: {pct(full, 0.5):.3f} ms a step (median of "
        f"{len(full)}, {full[0]:.3f}-{full[-1]:.3f}), cached_generate's "
        f"phase-5 step {'%.3f ms' % step_ms if step_ms else 'not measured'}"
        f"; launches {({k: v for k, v in counts.items() if v})}; captured "
        "and eager engines identical (tokens, finish reasons, "
        "dispatch_trace), every HTTP response's tokens equal to the eager "
        "engine's")
    return counts


def spec_frontend(dev, params, cfg) -> dict:
    """Phase 5c, speculative: 16 greedy requests of repetitive prompts (a
    phrase of 8-24 tokens repeated to 96-256) through the slot engine with
    speculative_k=4, captured and eager (identical tokens, finish reasons
    and dispatch_trace), then through the plain engine: the drafts
    accepted a dispatch, and the tokens held to the plain engine's up to
    near-ties (spec_ties). Returns the captured run's launch counts."""
    import gc

    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.serve.engine import (EngineConfig,
                                                              InferenceEngine)

    what = "front end, speculative_k=4"
    kw = dict(num_slots=16, max_seq_len=1024, kv_dtype="int8",
              decode_horizon=8)
    rng = np.random.default_rng(SEED + 12)
    prompts = []
    for _ in range(16):
        phrase = rng.integers(1, cfg.vocab_size, int(rng.integers(8, 25)))
        prompts.append(np.resize(phrase, int(rng.integers(96, 257))).tolist())
    runs = {}
    for label, cls, k in (("captured", InferenceEngine, 4),
                          ("eager", eager_slot_engine_class(), 4),
                          ("plain", InferenceEngine, 0)):
        eng = cls(params, cfg, EngineConfig(speculative_k=k, **kw))
        if label != "eager":
            eng.warmup()
        reset_launches()
        runs[label] = direct_run(eng, prompts, FRONT_TOKENS)
        if label == "captured":
            counts = read_launches()
            spec = eng.stats()["speculative"]
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    same_run(runs["captured"], runs["eager"], f"{what}: captured against "
             "eager dispatch")
    kinds = [t[0] for t in runs["captured"][1]]
    if "spec" not in kinds or counts["int8_matmul_prefill"] == 0:
        raise AssertionError(f"{what}: no verify window ran through K1 "
                             f"({kinds.count('spec')} windows; {counts})")
    ties = spec_ties(params, cfg, prompts,
                     [r.tokens for r in runs["plain"][0]],
                     [r.tokens for r in runs["captured"][0]],
                     "speculative_k=4 against the plain engine")
    log(f"{what} ({nvidia_smi()}): 16 slots, 16 requests of repetitive "
        f"prompts, {FRONT_TOKENS} greedy tokens: {kinds.count('spec')} "
        f"verify windows, {spec['tokens_per_dispatch']:.3f} tokens a request "
        f"a dispatch ({spec['tokens_per_dispatch'] - 1:.3f} drafts accepted "
        f"beside the bonus token); wall {runs['captured'][2]:.3f} s against "
        f"the plain engine's {runs['plain'][2]:.3f} s; captured and eager "
        f"identical; {ties}; launches "
        f"{({k: v for k, v in counts.items() if v})}")
    return counts


def paged_frontend(dev, params, cfg) -> dict:
    """Phase 5c, paged: the paged engine in phase 5's bench_serving7b
    geometry behind the same server, with no warmup(), as the CLI serves:
    every step is captured on the serving loop's thread at its first use.
    64 chat requests (K8, K5, K1), then abort_request on a running request,
    which must finish "aborted" (the reference's reason). Returns the
    wave's launch counts."""
    import gc

    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.serve.engine import GenerationRequest
    from physics_llm_inference_tpu_torch.serve.paged_engine import (
        PagedEngineConfig, PagedInferenceEngine)

    what = "front end, paged engine"
    eng = PagedInferenceEngine(params, cfg, PagedEngineConfig(
        max_batch=64, kv_dtype="int8", decode_horizon=8, enable_radix=True,
        prefill_tokens_per_iter=2048))
    contents = front_contents(SEED + 10, 64, *FRONT_PROMPTS, cfg.vocab_size)
    aborted = {}

    def abort_one(eng, srv):
        rid = eng.submit_request(GenerationRequest(
            prompt_tokens=np.arange(1, 129).tolist(), max_tokens=512,
            temperature=0.0))
        srv.loop.notify()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < FRONT_TIMEOUT:
            r = eng.scheduler.running.get(rid)
            if r is not None and len(r.output_tokens) >= 8:
                break
            time.sleep(0.005)
        aborted["ok"] = eng.abort_request(rid)
        aborted["res"] = eng.wait_result(rid, timeout=FRONT_TIMEOUT)

    reset_launches()
    eng.dispatch_trace = []
    got, wall, ttft = client_wave(eng, contents, 16, FRONT_TOKENS, what,
                                  during=abort_one)
    counts = read_launches()
    res = aborted.get("res")
    if not (aborted.get("ok") and res is not None
            and res.finish_reason == "aborted"
            and 8 <= len(res.tokens) < 512):
        raise AssertionError(f"{what}: abort_request on a running request "
                             f"gave {aborted}")
    if counts["fused_paged_decode_step"] == 0 or counts["flash_attention"] \
            == 0 or counts["int8_matmul"] == 0 or any(
            counts[k] for k in ("int8_paged_decode_attention",
                                "paged_decode_attention",
                                "fused_decode_step")):
        raise AssertionError(f"{what}: kernels not launched as expected: "
                             f"{counts}")
    if any(len(t) != FRONT_TOKENS or f != "length" for t, f in got):
        raise AssertionError(f"{what}: a response without {FRONT_TOKENS} "
                             "tokens")
    n_tok = 64 * FRONT_TOKENS
    log(f"{what} ({nvidia_smi()}): bench_serving7b geometry, no warmup() "
        f"(the loop thread captured {eng.stats()['prefill_compile']} "
        f"prefill buckets and {len(eng._decode_fns)} decode steps); 64 chat "
        f"requests from 16 clients: wall {wall:.3f} s, "
        f"{n_tok / wall:.1f} output tok/s, TTFT p50 "
        f"{pct(ttft, 0.5) * 1e3:.1f} ms p90 {pct(ttft, 0.9) * 1e3:.1f} ms; "
        f"abort_request on a running request: finish_reason "
        f"{res.finish_reason!r} after {len(res.tokens)} tokens; launches "
        f"{({k: v for k, v in counts.items() if v})}")
    # the first wave's wall holds its captures: a second wave of fresh
    # prompts replays what the first captured, and says what it added
    made = (eng.stats()["prefill_compile"]["misses"], len(eng._decode_fns))
    again = front_contents(SEED + 11, 64, *FRONT_PROMPTS, cfg.vocab_size)
    got, wall2, ttft2 = client_wave(eng, again, 16, FRONT_TOKENS,
                                    what + ", second wave")
    if any(len(t) != FRONT_TOKENS or f != "length" for t, f in got):
        raise AssertionError(f"{what}, second wave: a response without "
                             f"{FRONT_TOKENS} tokens")
    new = (eng.stats()["prefill_compile"]["misses"] - made[0],
           len(eng._decode_fns) - made[1])
    log(f"{what}, second wave of 64 fresh prompts ({nvidia_smi()}): wall "
        f"{wall2:.3f} s, {n_tok / wall2:.1f} output tok/s, TTFT p50 "
        f"{pct(ttft2, 0.5) * 1e3:.1f} ms p90 {pct(ttft2, 0.9) * 1e3:.1f} "
        f"ms; captures made in it: {new[0]} prefill buckets, {new[1]} "
        f"decode steps (first wave: {made[0]} prefill buckets, {made[1]} "
        f"decode steps)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def cli_check():
    """`cli serve --config llama7b --int8 --check` on the card."""
    import gc

    import torch

    from physics_llm_inference_tpu_torch import cli

    t0 = time.perf_counter()
    cli.main(["serve", "--config", "llama7b", "--int8", "--check",
              "--port", "0"])
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"front end, cli serve --config llama7b --int8 --check --port 0: "
        f"ok in {time.perf_counter() - t0:.1f} s")


def frontend_runs(dev, params, step_ms=None) -> dict:
    """Phase 5c: the slot engine behind the HTTP server, the speculative
    engine, the paged engine behind the server, the CLI's serve check.
    Returns the launches of the slot and paged HTTP waves and of the
    captured speculative run."""
    cfg = serving_cfg()
    t0 = time.perf_counter()
    runs = [slot_frontend(dev, params, cfg, step_ms),
            spec_frontend(dev, params, cfg),
            paged_frontend(dev, params, cfg)]
    cli_check()
    log(f"phase 5c (front end): {time.perf_counter() - t0:.1f} s")
    return {k: sum(r[k] for r in runs) for k in KERNELS}


def frontend_alone(dev):
    """--frontend: phase 5c alone, on the INT8 7B-class weights."""
    import torch

    from physics_llm_inference_tpu_torch.models.quant import init_params_int8

    cfg = serving_cfg()
    frontend_runs(dev, init_params_int8(
        torch.Generator(device=dev).manual_seed(SEED), cfg))


# phase 5d: the MoE model family at BASELINE config 5's widths
# (scripts/bench_moe.py: hidden 2048, 16 q / 4 kv heads, 8 experts top-2 of
# FFN 2816, capacity factor 1.25, INT8 weights and KV)
MOE_WIDTHS = dict(vocab_size=32000, hidden_dim=2048, num_heads=16,
                  num_kv_heads=4, intermediate_dim=2816, max_seq_len=1024,
                  dtype="bfloat16", num_experts=8, num_experts_per_tok=2,
                  expert_capacity_factor=1.25)
MOE_BATCH, MOE_PROMPT, MOE_TOKENS, MOE_LAYERS = 32, 128, 64, 16
MOE_RTOL = 2e-2      # a held row's relative error, phase 4's per-op rule
# a routing change is excused only at a near-tie: the reference's top k+1
# router logits of the token within this of each other. A held row's
# logits move by about its relative error (a unit-norm gate column against
# a sqrt(D)-norm input), ~1e-3 for K1/K2 rounding: 0.05 is far above that,
# and a defect upstream of a router moves logits by ~0.1-1
MOE_MARGIN = 0.05
# what an MoE path must not launch: K4 and K8 have no MoE mode
MOE_FORBID = ("fused_decode_step", "fused_decode_step_w4a16",
              "fused_decode_step_w8a8", "fused_paged_decode_step")


def moe_cfg(layers: int):
    from physics_llm_inference_tpu_torch.models.config import ModelConfig

    return ModelConfig(num_layers=layers, **MOE_WIDTHS)


def moe_params(dev, cfg, seed: int):
    """quantize_params_int8(init_params(...)) on the card, as
    scripts/bench_moe.py makes its weights (init_params_int8 is dense)."""
    import torch

    from physics_llm_inference_tpu_torch.models.quant import \
        quantize_params_int8
    from physics_llm_inference_tpu_torch.models.transformer import \
        init_params

    params = quantize_params_int8(init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return params


class moe_routes:
    """Within the block, each routed layer's call is recorded on the host,
    in call order: (indices (T, K), kept (T, K), the router's probs
    (T, E)). Controls, here and not in the package: `short` gives each
    call one slot less of capacity an expert; `unnormalised` hands the
    layer the router's top-k probabilities without their
    renormalisation."""

    def __init__(self, short: bool = False, unnormalised: bool = False):
        self.short, self.unnormalised = short, unnormalised
        self.calls, self.probs = [], []

    def __enter__(self):
        import torch

        from physics_llm_inference_tpu_torch.models import moe

        self.moe = moe
        self.saved = (moe._dispatch_slots, moe.router)
        dispatch, router = self.saved

        def spy_dispatch(indices, weights, e, c, valid=None):
            cc = c - 1 if self.short else c
            slot, comb = dispatch(indices, weights, e, cc, valid)
            if self.short:   # the same grid, one slot an expert unused
                kept = slot < e * cc
                slot = torch.where(kept, slot - indices * cc + indices * c,
                                   e * c)
            self.calls.append((indices.cpu(), (slot < e * c).cpu(),
                               self.probs.pop()))
            return slot, comb

        def spy_router(x, gate, k):
            w, i, p = router(x, gate, k)
            self.probs.append(p.cpu())
            if self.unnormalised:
                w = p.gather(1, i)
            return w, i, p

        moe._dispatch_slots, moe.router = spy_dispatch, spy_router
        return self

    def __exit__(self, *exc):
        self.moe._dispatch_slots, self.moe.router = self.saved


def moe_moved(calls_a, calls_b, stages, layers: int):
    """Per stage (`layers` routing calls each; `stages` holds each stage's
    (label, rows), its rows as request ids), the tokens whose routing
    moved between two runs (a: under test, b: the reference), up to and
    including that stage. A token moved where it changed experts in a call
    where the reference's top k+1 router logits of that token lie within
    MOE_MARGIN of each other (a near-tie that rounding can flip), and where
    it kept or lost a slot the other run did not in a call where some
    token changed experts (a pair moved by a routing change can take a
    later pair's slot). The later tokens of its request move with it
    (attention reads it), and so does every token of that request in a
    later stage. Returns (a list of (b, s) bool tensors, one a stage, the
    defects): a call where a token not moved before changes experts at a
    clear margin, and a call where no token changed experts but a pair
    kept or lost its slot (on the same experts the slots follow from the
    routing alone)."""
    import torch

    req = torch.zeros(max(int(r.max()) for _, r in stages) + 1,
                      dtype=torch.bool)
    out, defects = [], []
    for j, (_, rows) in enumerate(stages):
        b, state = rows.numel(), None
        for i in range(j * layers, (j + 1) * layers):
            (ia, ka, _), (ib, kb, pb) = calls_a[i], calls_b[i]
            k = ib.shape[-1]
            top = pb.sort(dim=-1, descending=True).values[:, :k + 1].log()
            margin = (top[:, :-1] - top[:, 1:]).min(dim=-1).values   # (T,)
            flip = (ia != ib).any(dim=-1).reshape(b, -1)
            kept = (ka != kb).any(dim=-1).reshape(b, -1)
            if state is None:
                state = req[rows][:, None].expand_as(flip).clone()
            clear = flip & (margin.reshape(b, -1) > MOE_MARGIN)
            if bool((clear & ~state).any()):
                at = torch.nonzero(clear & ~state).tolist()
                defects.append(f"call {i}: (row, token) {at[:8]} changed "
                               f"experts at a margin above {MOE_MARGIN:g}")
            if bool(kept.any()) and not bool(flip.any()):
                defects.append(f"call {i}: pairs kept other slots on the "
                               "same experts")
            hit = flip | (kept & bool(flip.any()))
            state |= hit.to(torch.int8).cummax(dim=1).values.bool()
        out.append(state.clone())
        req[rows] |= state.any(dim=1)
    return out, defects


def moe_rule(run_a, run_b, stages, layers: int, what: str) -> str:
    """Phase 5d's parity rule between two runs, each (a list of outputs,
    one a stage: (b, V) a row or (b, s, V) a token; the routing calls of
    `moe_routes`), a under test and b the reference: no routing defect
    (`moe_moved`), and every output whose routing did not move (a (b, V)
    row: none of its tokens) within MOE_RTOL of the reference's, relative
    to its own norm. Raises on a failure; returns what it saw."""
    (outs_a, calls_a), (outs_b, calls_b) = run_a, run_b
    if len(calls_a) != len(stages) * layers or len(outs_a) != len(stages):
        raise AssertionError(f"{what}: {len(calls_a)} routing calls and "
                             f"{len(outs_a)} outputs for {len(stages)} "
                             f"stages of {layers} layers")
    moved, defects = moe_moved(calls_a, calls_b, stages, layers)
    if defects:
        raise AssertionError(f"{what}: {len(defects)} routing defects in "
                             f"{len(calls_a)} calls, the first "
                             f"{defects[0]}")
    held = []
    for (label, _), a, r, m in zip(stages, outs_a, outs_b, moved):
        m = m.any(dim=1) if a.dim() == 2 else m
        rel = rows_rel(a.float(), r.float()).cpu()[~m]
        worst = float(rel.max()) if rel.numel() else 0.0
        if worst > MOE_RTOL:
            raise AssertionError(
                f"{what}, {label}: an output whose routing did not move is "
                f"{worst:.4g} from the reference's (rule {MOE_RTOL:g}); "
                f"{int(m.sum())} of {m.numel()} moved")
        held.append(f"{label}: {int((~m).sum())}/{m.numel()} held, worst "
                    f"{worst:.4g}")
    return f"rule {MOE_RTOL:g}; " + ", ".join(held)


def slice_stages(b: int, steps: int):
    """run_slice's stages for moe_rule: the prefill, then each step, over
    the same b requests."""
    import torch

    rows = torch.arange(b)
    return [("prefill logits", rows)] + [(f"step {i}", rows)
                                         for i in range(steps)]


def moe_slice(params, cfg, prompts, steps, dev, routes):
    """run_slice under `routes` (a moe_routes): (the outputs a stage (the
    prefill logits, then each step's final hidden state), the routing
    calls), and each step's (hidden, token)."""
    with routes:
        logits, seen = run_slice(params, cfg, prompts, steps, dev)
    return ([logits.float()] + [x for x, _ in seen], routes.calls), seen


class kernel_probe:
    """Within the block, the model modules' kernel entry points (`names`)
    record the inputs (cloned) of their first call at each shape (K4: at
    each shape and mode), or of call number `at[name]` (from 0) there;
    `check()` then calls each entry point and its plain version on those
    inputs and holds them to the kernel's phase-3 rule: K1 rtol 1e-2 plus
    1e-3 of the output's max, K2, K5, K6 and K7 2e-2 absolute (K5 on live
    rows: flash_err), K3's token within one bf16 ulp of the plain row max,
    K4 by its mode's rule (k4_rule). Its launches are comparisons, not the
    main path's."""

    NAMES = ("int8_matmul", "int8_kv_decode_attention", "flash_attention",
             "int8_paged_decode_attention", "paged_decode_attention",
             "moe_experts")

    def __init__(self, names=NAMES, at=None):
        self.names, self.at = names, at or {}
        self.calls, self.seen = {}, {}

    def __enter__(self):
        from physics_llm_inference_tpu_torch.models import moe as mo
        from physics_llm_inference_tpu_torch.models import \
            paged_transformer as pt
        from physics_llm_inference_tpu_torch.models import transformer as tf

        self.saved = [(m, n, getattr(m, n)) for m in (tf, pt, mo)
                      for n in self.names if hasattr(m, n)]
        for m, n, fn in self.saved:
            setattr(m, n, self.spy(n, fn))
        return self

    def spy(self, name, fn):
        import torch

        def clone(a):
            return a.clone() if isinstance(a, torch.Tensor) else a

        def call(*a, **kw):
            key = (name,) + tuple(tuple(x.shape) for x in a
                                  if isinstance(x, torch.Tensor))
            if name == "fused_decode_step":
                key += (k4_mode(a[0], a[-1]),)
            n = self.seen[key] = self.seen.get(key, -1) + 1
            if n == self.at.get(name, 0):
                self.calls[key] = ([clone(x) for x in a],
                                   {k: clone(v) for k, v in kw.items()})
            return fn(*a, **kw)

        return call

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)

    def check(self, what: str) -> str:
        """Every recorded call held to its rule; raises after the last one
        with every call that failed, beside the readings of the others."""
        parts, faults = [], []
        for key, (a, kw) in self.calls.items():
            try:
                parts.append(self.check_one(key, a, kw, what))
            except AssertionError as e:
                faults.append(str(e))
        if faults:
            raise AssertionError(" | ".join(faults) + "; held: "
                                 + "; ".join(parts))
        return "; ".join(parts)

    @staticmethod
    def check_one(key, a, kw, what: str) -> str:
        import torch

        name, mod = key[0], kernel_module(key[0])
        fn, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
        tag = name
        if name == "int8_matmul":
            m, k = a[0].shape
            n = a[1].shape[-1]
            tag = f"K1 {mod.pick_route(m, n, k)} ({m},{k},{n})"
        if name == "flash_attention":
            err = flash_err(mod, a, kw, f"{what} {tuple(a[0].shape)}")
            return f"K5 q {tuple(a[0].shape)} k {tuple(a[1].shape)} {err:.4g}"
        if name == "lmhead_greedy":
            return k3_rule(mod, a, kw, what)
        if name == "fused_decode_step":
            return k4_rule(a, kw, key[-1], what)
        got = fn(*a, **kw).float()
        want = plain(*a, **kw).float()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        if name == "moe_experts":
            tag = f"moe_experts {tuple(a[0].shape)}"
        if name in ("int8_matmul", "moe_experts"):
            lim = 1e-2 * want.abs() + 1e-3 * float(want.abs().max())
        else:
            lim = torch.full_like(want, 2e-2)
            tag = f"{name} q {tuple(a[0].shape)}"
        if not bool(torch.isfinite(got).all()) or bool((diff > lim).any()):
            raise AssertionError(f"{what}: {tag} off its plain version on the "
                                 f"path's inputs, max abs err "
                                 f"{float(diff.max()):.4g}")
        return f"{tag} {float(diff.max()):.4g}"

    def kinds(self) -> set:
        """(name, K1's route or None, K1's K, K4's mode or None) of each
        recorded call."""
        out = set()
        for key, (a, _) in self.calls.items():
            if key[0] == "int8_matmul":
                m, k = a[0].shape
                out.add((key[0], kernel_module(key[0]).pick_route(
                    m, a[1].shape[-1], k), k))
            elif key[0] == "fused_decode_step":
                out.add((key[0], key[-1], None))
            else:
                out.add((key[0], None, None))
        return out


def k4_mode(blocks, cfg) -> str:
    """The FUSED_MODES mode of a fused_decode_step call."""
    from physics_llm_inference_tpu_torch.models.quant import QuantizedTensor4

    if isinstance(blocks["wqkv"], QuantizedTensor4):
        return "w4a16"
    return "w8a8" if cfg.act_quant == "int8" else "w8a16"


def k3_rule(kh, a, kw, what: str) -> str:
    """K3 on recorded inputs (x, norm, lm_q, lm_s; eps): each row's token
    carries a plain logit within one bf16 ulp of the plain row maximum,
    phase 3's rule."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import int8_matmul as km
    from physics_llm_inference_tpu_torch.ops.norms import rms_norm

    x, nw, lq, ls = a
    tok = kh.lmhead_greedy(*a, **kw).long()
    logits = km.int8_matmul_plain(rms_norm(x, nw, kw["eps"]), lq, ls,
                                  out_dtype=torch.float32).bfloat16().float()
    top = logits.max(dim=-1).values
    gap = top - logits.gather(1, tok[:, None])[:, 0]
    if bool((gap > bf16_ulp(top)).any()):
        raise AssertionError(f"{what}: K3's token logit {float(gap.max()):.4g}"
                             " below the plain row max, more than one bf16 "
                             "ulp")
    return f"K3 B={x.shape[0]} gap to the row max {float(gap.max()):.4g}"


# Controls of W4A16's rule that cannot break it on phase 5e's inputs (the
# decode path's step at LLAMA_7B_CONFIG's widths), each with why; phase 3
# requires them at its own inputs. Every other control is required.
ACC_W4A16_UNSEPARATED = {
    name: "one bf16 rounding a layer moves these rows by half the 2e-2 "
          "floor of the bound, where phase 3's INT4 inputs, with rows 100x "
          "larger and cancelling, move them past it"
    for name in ("bf16 q.k", "bf16 P@V")}


def k4_rule(a, kw, mode: str, what: str) -> str:
    """K4 on recorded inputs (blocks, x, the cache's four tensors, q_slot,
    valid_from, cos, sin, cfg; slot, write_cache), each version on its own
    copy of the cache, by its mode's phase-3 rule. W8A16 and W4A16 hold the
    whole step the path launched: every x_out row within 2e-2 of its own
    norm; check_w4a16_rows' bound, with every control that breaks it on
    these inputs required to (ACC_W4A16_UNSEPARATED names the others).
    Phase 3 states W8A8's rule for 2 layers, and a flipped int8 activation
    code moves every later layer, so w8a8_windows holds W8A8 two layers at
    a time over the whole stack, each window from the plain version's
    hidden state at its depth; the whole step's drift from the plain
    version is reported beside the plain version's own drift from a
    one-ulp change of its input (w8a8_drift). A valid_from of None (every
    key from slot 0) is given as zeros, which the controls need."""
    import torch

    kf = kernel_module("fused_decode_step")
    blocks, x, cache = a[0], a[1], a[2:6]
    qslot, vfrom, cos, sin, cfg = a[6:]
    if vfrom is None:
        vfrom = torch.zeros_like(qslot, dtype=torch.int32)
    args = (qslot, vfrom, cos, sin, cfg)

    def run(fn, x_in=x):
        return fn(blocks, x_in, *[t.clone() for t in cache], *args,
                  **kw)[0].float()

    got, want = run(kf.fused_decode_step), run(kf.fused_decode_step_plain)
    torch.cuda.synchronize()
    tag = f"{what}: K4 {mode.upper()} B={x.shape[0]}, {cfg.num_layers} layers"
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: x_out not finite")
    if mode == "w8a8":
        rows = (w8a8_windows(kf, blocks, x, cache, args, kw, tag) + "; "
                + w8a8_drift(got, want, run(kf.fused_decode_step_plain,
                                            ulp_moved(x))))
    elif mode == "w4a16":
        rows = check_w4a16_rows(blocks, x, cache, args, kw, got, want, tag,
                                ACC_W4A16_UNSEPARATED)
    else:
        worst = row_rel(got, want)
        if worst > 2e-2:
            raise AssertionError(f"{tag}: x_out row-wise relative error "
                                 f"{worst:.4g} > 2e-2")
        rows = f"worst row {worst:.4g} (2e-2)"
    live = int((qslot - vfrom).min()), int((qslot - vfrom).max())
    return (f"K4 {mode.upper()} ({live[0]}-{live[1]} cached keys live), "
            f"{cfg.num_layers} layers: {rows}")


def w8a8_windows(kf, blocks, x, cache, args, kw, what: str,
                 require_controls: bool = True) -> str:
    """K4 W8A8 held over the whole stack two layers at a time: window i
    runs layers 2i and 2i + 1 (the stacks' and the cache's) from the plain
    version's x_out of window i - 1 (the path's x for the first), with the
    kernel and with the plain version, each on its own copy of the cache;
    every window is held to W8A8_TILED. A kernel that skips a quantization
    point skips it in every layer, so each control (w8a8_controls) must
    break the rule in at least one window. Returns the readings: the
    kernel's worst window, and each control's count of windows that catch
    it and its window nearest to passing. With `require_controls` False
    (the trained model's readings, phase 5g) a control that no window
    catches is reported, not raised: the rule's power is what is read."""
    import dataclasses

    import torch

    from physics_llm_inference_tpu_torch.models.quant import (
        QuantizedTensor, QuantizedTensor4)

    qslot, vfrom, cos, sin, cfg = args
    args2 = (qslot, vfrom, cos, sin, dataclasses.replace(cfg, num_layers=2))
    said = f"median <= {W8A8_TILED[0]:g}, worst <= {W8A8_TILED[1]:g}"
    h, meds, worsts = x, [], []
    caught = {p: 0 for p in QUANT_POINTS}
    nearest = {p: (float("inf"), 0.0, 0) for p in QUANT_POINTS}
    for l in range(0, cfg.num_layers, 2):
        cut = {n: (type(w)(w.q[l:l + 2], w.s[l:l + 2])
                   if isinstance(w, (QuantizedTensor, QuantizedTensor4))
                   else w[l:l + 2]) for n, w in blocks.items()}
        cache2 = [t[l:l + 2] for t in cache]

        def run(fn, cut=cut, cache2=cache2, h=h):
            return fn(cut, h, *[t.clone() for t in cache2], *args2, **kw)[0]

        got = run(kf.fused_decode_step).float()
        nxt = run(kf.fused_decode_step_plain)
        want = nxt.float()
        torch.cuda.synchronize()
        rel = rows_rel(got, want)
        meds.append(float(rel.median()))
        worsts.append(float(rel.max()))
        if not w8a8_passes(rel):
            raise AssertionError(f"{what}, layers {l}-{l + 1}: median "
                                 f"{meds[-1]:.4g}, worst {worsts[-1]:.4g}, "
                                 f"outside {said}")
        controls = w8a8_controls(
            lambda: run(kf.fused_decode_step_plain).float(), want, 2)
        for p, r in controls.items():
            caught[p] += not w8a8_passes(r)
            m = float(r.median())
            if m < nearest[p][0]:
                nearest[p] = (m, float(r.max()), l)
        h = nxt
    i = max(range(len(meds)), key=meds.__getitem__)
    readings = (
        f"{len(meds)} two-layer windows, each from the plain version's "
        f"hidden state at its depth, within {said}: the largest median "
        f"{meds[i]:.4g} (layers {2 * i}-{2 * i + 1}), the worst row "
        f"{max(worsts):.4g}; controls, windows that catch each of "
        f"{len(meds)}, and its window nearest to passing: " + ", ".join(
            f"{p} {caught[p]} (median {m:.4g}, worst {w:.4g} at layers "
            f"{l}-{l + 1})" for p, (m, w, l) in nearest.items()))
    if require_controls and not all(caught.values()):
        raise AssertionError(f"{what}: a control that no window catches: "
                             f"{readings}")
    return readings


def ulp_moved(x):
    """`x` (bf16) with the first element of each row moved one ulp away
    from zero."""
    import torch

    bits = x.view(torch.int16).clone()
    bits[:, 0] += 1
    return bits.view(torch.bfloat16)


def w8a8_drift(got, want, moved) -> str:
    """The whole W8A8 step's x_out rows against the plain version's
    (`got`, `want`), beside the plain version's own rows from an input one
    ulp away (`moved`) against `want`: a witness that the plain
    arithmetic alone drifts as far over the stack."""
    kern, own = rows_rel(got, want), rows_rel(moved, want)
    return (f"the whole step: x_out rows off the plain version's by median "
            f"{float(kern.median()):.4g}, worst {float(kern.max()):.4g}; "
            f"the plain version from x moved by one ulp in one element a "
            f"row: median {float(own.median()):.4g}, worst "
            f"{float(own.max()):.4g}")


def moe_slice_parity(dev):
    """Phase 5d, part 1: config 5's widths at 2 layers, prefill plus 8
    teacher-forced decode steps with the kernels (K1 "stream", K2, K3;
    prefill's B x S >= 2,048 rows take the library GEMM on both runs) and
    with their entry points swapped for their plain versions. Rows whose
    routing moved are reported (K1/K2 rounding can move a bf16 router
    logit across a tie); the others are held to MOE_RTOL; each kernel
    token lies within one bf16 ulp of the plain head's max on the kernel
    run's hidden state, and K1 and K2 are held against their plain
    versions on the inputs the slice gave them (kernel_probe). Two
    controls, each the plain run with one defect (one slot less of
    capacity; weights not renormalised), must break the rule."""
    import torch

    cfg = moe_cfg(2)
    params = moe_params(dev, cfg, SEED + 1)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    lens = torch.randint(MOE_PROMPT // 2, MOE_PROMPT + 1, (MOE_BATCH,),
                         generator=g, device=dev)
    prompts = [torch.randint(1, cfg.vocab_size, (int(n),), generator=g,
                             device=dev).tolist() for n in lens]
    steps = [torch.randint(1, cfg.vocab_size, (MOE_BATCH,), generator=g,
                           device=dev) for _ in range(8)]
    stages = slice_stages(MOE_BATCH, len(steps))
    path = ("int8_matmul", "int8_kv_decode_attention", "lmhead_greedy",
            "moe_experts")
    before = read_launches()
    with kernel_probe() as probe:
        got, seen = moe_slice(params, cfg, prompts, steps, dev, moe_routes())
    after = read_launches()
    used = {n: after[n] - before[n] for n in path + MOE_FORBID}
    if min(used[n] for n in path) == 0 or any(used[n] for n in MOE_FORBID):
        raise AssertionError(f"MoE slice parity: kernels not used as "
                             f"expected {used}")
    with plain_entry_points():
        want, seen_plain = moe_slice(params, cfg, prompts, steps, dev,
                                     moe_routes())
    note = moe_rule(got, want, stages, 2, "MoE slice parity")
    own = torch.cat([ulps_below_max(params, cfg, x, t) for x, t in seen])
    if bool((own > 1).any()):
        raise AssertionError(f"MoE slice parity: K3's token off the plain "
                             f"head's max: {ulp_rows(own, 1)}")
    kinds = probe.kinds()
    if not {("int8_matmul", "stream", cfg.hidden_dim),
            ("int8_kv_decode_attention", None, None),
            ("moe_experts", None, None)} <= kinds:
        raise AssertionError(f"MoE slice parity: the probe saw {kinds}")
    probed = probe.check("MoE slice parity")
    moved, _ = moe_moved(got[1], want[1], stages, 2)
    flips = sum(int((a[0] != b[0]).any(dim=-1).sum())
                for a, b in zip(got[1], want[1]))
    equal = sum(int((tk == tp).sum()) for (_, tk), (_, tp) in zip(seen,
                                                                   seen_plain))
    broken = {}
    for name, kw in (("capacity one slot short", dict(short=True)),
                     ("weights not renormalised", dict(unnormalised=True))):
        with plain_entry_points():
            ctl, _ = moe_slice(params, cfg, prompts, steps, dev,
                               moe_routes(**kw))
        try:
            moe_rule(ctl, want, stages, 2, name)
        except AssertionError as e:
            broken[name] = str(e)
            continue
        raise AssertionError(f"MoE slice parity: the control '{name}' "
                             "passes the rule")
    log(f"MoE slice parity (config 5 widths, 2 layers, B={MOE_BATCH}, 8 "
        f"decode steps, {nvidia_smi()}): {note}; rows moved by the last "
        f"step {int(moved[-1].sum())} ({flips} (token, layer) routing "
        f"changes over {len(got[1])} calls); K3's tokens within one bf16 "
        f"ulp of the plain head's max on every row; tokens equal to the "
        f"plain run's on {equal} of {len(seen) * MOE_BATCH}; kernel "
        f"launches {used}; the kernels on the slice's inputs against their "
        f"plain versions (max abs err): {probed}; controls broken: "
        + " | ".join(broken.values()))
    del params
    torch.cuda.empty_cache()


MOE_CHUNKS = (128, 128, 100, 61)   # the slot engine's chunks: real tokens
MOE_PAGED_R = 16                   # requests a paged prefill chunk
MOE_BLOCK, MOE_MB = 16, 16         # the paged pools' blocks, a request's


def moe_engine_steps(params, cfg, dev, routes, decode_pools=None):
    """The engines' step functions at phase 5d's geometry, under `routes`
    (a moe_routes): each of MOE_CHUNKS as a slot-engine prefill chunk (b
    = 1, bucket 128, right padding of token 0) into a fresh INT8 slot
    buffer of 256 positions, as serve/engine.prefill_chunk calls
    `forward`; then two paged prefill chunks of MOE_PAGED_R requests x 128
    (ragged, right-padded) into INT8 pools of MOE_MB blocks of MOE_BLOCK a
    request (scattered tables), and one paged decode step of all of them,
    from a copy of `decode_pools` where given (another run's pools: the
    step alone is compared). Returns ((the outputs a stage: each slot
    chunk's logits (1, 128, V), each paged chunk's final hidden state (R,
    128, D), a token each, the decode step's logits (2R, V); the routing
    calls), the stages, the pools before the decode step)."""
    import torch

    from physics_llm_inference_tpu_torch.models import \
        paged_transformer as pt
    from physics_llm_inference_tpu_torch.models import transformer as tf

    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    nl, hkv, hd, c = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 128
    outs, stages = [], []
    with routes:
        for i, n in enumerate(MOE_CHUNKS):
            ids = torch.zeros((1, c), dtype=torch.long, device=dev)
            ids[0, :n] = torch.randint(1, cfg.vocab_size, (n,), generator=g,
                                       device=dev)
            slot_k, slot_v = (tf.QuantKV(
                q=torch.zeros((nl, 1, 256, hkv * hd), dtype=torch.int8,
                              device=dev),
                s=torch.zeros((nl, 1, hkv, 256), device=dev))
                for _ in "kv")
            start = torch.zeros((), dtype=torch.int32, device=dev)
            slots = (torch.arange(c, device=dev)[None, :] + start)
            logits, _ = tf.forward(params, ids, cfg,
                                   kv=tf.KVSlice(slot_k, slot_v, start),
                                   positions=slots, slots=slots)
            outs.append(logits.float())
            stages.append((f"slot chunk {i} ({n} tokens)",
                           torch.tensor([i])))
        r = MOE_PAGED_R
        nb = 2 * r * MOE_MB
        pools = tf.QuantKV(
            q=torch.zeros((nl, nb + 1, 2, MOE_BLOCK, hkv * hd),
                          dtype=torch.int8, device=dev),
            s=torch.zeros((nl, nb + 1, 2, hkv, MOE_BLOCK), device=dev))
        tables = torch.randperm(nb, generator=g, device=dev).reshape(
            2 * r, MOE_MB).int()
        nvalid = torch.randint(c // 2, c + 1, (2 * r,), generator=g,
                               device=dev)
        base = len(MOE_CHUNKS)
        # each paged chunk's final hidden state, x + _ffn(rms_norm(x)) of
        # its last layer: the last norm's input plus the last FFN output
        ffn, norm, last = pt._ffn, pt.rms_norm, {}

        def spy_ffn(*a, **kw):
            last["ffn"] = ffn(*a, **kw)
            return last["ffn"]

        def spy_norm(x, *a, **kw):
            last["x"] = x
            return norm(x, *a, **kw)

        pt._ffn, pt.rms_norm = spy_ffn, spy_norm
        try:
            for j in range(2):
                rows = slice(j * r, (j + 1) * r)
                ids = torch.randint(1, cfg.vocab_size, (r, c), generator=g,
                                    device=dev)
                ids = torch.where(torch.arange(c, device=dev)[None, :]
                                  < nvalid[rows, None], ids, 0)
                _, pools, _ = pt.paged_prefill_chunk_impl(
                    params, ids, pools, None, tables[rows],
                    torch.zeros(r, dtype=torch.int32, device=dev),
                    nvalid[rows], cfg)
                outs.append((last["x"] + last["ffn"]).float())
                stages.append((f"paged chunk {j}", torch.arange(
                    base + j * r, base + (j + 1) * r)))
        finally:
            pt._ffn, pt.rms_norm = ffn, norm
        before = tf.QuantKV(pools.q.clone(), pools.s.clone())
        if decode_pools is not None:
            pools = tf.QuantKV(decode_pools.q.clone(), decode_pools.s.clone())
        tokens = torch.randint(1, cfg.vocab_size, (2 * r,), generator=g,
                               device=dev).int()
        logits, pools, _ = pt.paged_decode_step(params, tokens, pools, None,
                                                tables, nvalid.int(), cfg)
        outs.append(logits.float())
        # requests of their own: the step starts from the same pools
        stages.append(("paged decode step",
                       torch.arange(base + 2 * r, base + 4 * r)))
        torch.cuda.synchronize()
    return (outs, routes.calls), stages, before


def moe_engine_parity(dev):
    """Phase 5d, part 1b: the slot and the paged engine's step functions
    at config 5's widths, 2 layers (moe_engine_steps), with the kernels
    (the slot chunks: K1 "wgmma" at 128 rows, K = 2,048; the paged chunks:
    K5, their 2,048-row linears the library GEMM on both runs; the paged
    decode step: K1 "stream" at 32 rows, K6) and with the dense and paged
    models' entry points swapped for their plain versions (its decode step
    from the kernel run's pools), under moe_rule, a token at a time where
    the step gives each token's output; then each kernel held against its
    plain version on the inputs the steps gave it (kernel_probe)."""
    import torch

    cfg = moe_cfg(2)
    params = moe_params(dev, cfg, SEED + 2)
    path = ("int8_matmul", "int8_matmul_prefill", "flash_attention",
            "int8_paged_decode_attention", "moe_experts")
    before = read_launches()
    with kernel_probe() as probe:
        got, stages, pools = moe_engine_steps(params, cfg, dev, moe_routes())
    after = read_launches()
    used = {n: after[n] - before[n] for n in path + MOE_FORBID}
    if min(used[n] for n in path) == 0 or any(used[n] for n in MOE_FORBID):
        raise AssertionError(f"MoE engine steps: kernels not used as "
                             f"expected {used}")
    with plain_entry_points():
        want, _, _ = moe_engine_steps(params, cfg, dev, moe_routes(), pools)
    note = moe_rule(got, want, stages, 2, "MoE engine steps")
    d = cfg.hidden_dim
    need = {("int8_matmul", "wgmma", d), ("int8_matmul", "stream", d),
            ("flash_attention", None, None),
            ("int8_paged_decode_attention", None, None),
            ("moe_experts", None, None)}
    if not need <= probe.kinds():
        raise AssertionError(f"MoE engine steps: the probe saw "
                             f"{probe.kinds()}, not all of {need}")
    probed = probe.check("MoE engine steps")
    flips = sum(int((a[0] != b[0]).any(dim=-1).sum())
                for a, b in zip(got[1], want[1]))
    log(f"MoE engine steps (config 5 widths, 2 layers, {nvidia_smi()}): "
        f"{len(MOE_CHUNKS)} slot-engine prefill chunks of 128 (real tokens "
        f"{list(MOE_CHUNKS)}), 2 paged chunks of {MOE_PAGED_R} x 128 and a "
        f"paged decode step of {2 * MOE_PAGED_R} from the same pools (INT8, "
        f"blocks of {MOE_BLOCK}): {note}; {flips} (token, layer) routing changes "
        f"over {len(got[1])} calls; kernel launches {used}; the kernels on "
        f"the steps' inputs against their plain versions (max abs err): "
        f"{probed}")
    del params
    torch.cuda.empty_cache()


def moe_full_run(dev, params, cfg) -> dict:
    """Phase 5d, part 2: cached_generate at B 32, prompt 128, 64 greedy
    tokens over an INT8 cache, its decode loop replayed from a graph and
    held against the eager loop; the floors of scripts/bench_moe.py.
    Returns the timed run's launches."""
    import torch

    from physics_llm_inference_tpu_torch.bench.moe import (floors_s,
                                                           param_counts)
    from physics_llm_inference_tpu_torch.runtime.generate import (
        cached_generate, decode_step_cache)
    from physics_llm_inference_tpu_torch.specs.gpu import get_gpu_spec

    g = torch.Generator().manual_seed(SEED + 12)
    prompts = torch.randint(1, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                            generator=g).tolist()
    steps = decode_step_cache()

    def run():
        return cached_generate(params, cfg, prompts, MOE_TOKENS,
                               temperature=0.0, kv_dtype=torch.int8,
                               step_cache=steps)

    t0 = time.perf_counter()
    run()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = run()
    counts = read_launches()
    what = f"MoE {cfg.num_layers} layers, cached_generate"
    need = ("int8_matmul", "int8_kv_decode_attention", "lmhead_greedy",
            "moe_experts")
    if any(counts[n] == 0 for n in need) or any(counts[n]
                                                for n in MOE_FORBID):
        raise AssertionError(f"{what}: kernels not launched as expected: "
                             f"{counts}")
    if steps.stats() != {"compiled_shapes": 1, "hits": 1, "misses": 1}:
        raise AssertionError(f"{what}: the timed run did not replay the "
                             f"warm run's graph: {steps.stats()}")
    toks = out.tokens
    if toks.shape != (MOE_BATCH, MOE_TOKENS) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{what}: bad tokens {toks.shape}")
    eager, eager_s, host = eager_decode(params, cfg, prompts, False, steps,
                                        MOE_TOKENS)
    if not (eager == toks).all():
        raise AssertionError(f"{what}: graph replay's greedy tokens differ "
                             "from the eager loop's at "
                             f"{int((eager != toks).sum())} places")
    spec = get_gpu_spec()
    total, active = param_counts(params, cfg, cfg.num_experts_per_tok)
    f_all, f_act = floors_s(total, active, cfg, MOE_BATCH, MOE_PROMPT,
                            MOE_TOKENS, spec)
    step_s = out.decode_s / MOE_TOKENS
    log(f"{what} (B={MOE_BATCH}, prompt {MOE_PROMPT}, {MOE_TOKENS} greedy "
        f"tokens, INT8 W+KV, {nvidia_smi()}): {total / 1e9:.2f}B total / "
        f"{active / 1e9:.2f}B active params; warm-up run {warm:.1f} s; "
        f"TTFT {out.prefill_s * 1e3:.1f} ms; graph replay "
        f"{step_s * 1e3:.3f} ms a step, {out.decode_tokens_per_s:.1f} "
        f"tok/s; eager loop {eager_s / MOE_TOKENS * 1e3:.3f} ms a step; "
        f"greedy tokens identical; all-expert floor {f_all * 1e3:.3f} ms "
        f"a step (share {f_all / step_s:.4f}), active-expert floor "
        f"{f_act * 1e3:.3f} ms (share {f_act / step_s:.4f}) on {spec.name} "
        f"spec; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB; {host}; launches {({k: v for k, v in counts.items() if v})}")
    profile_wave(run, what, out.prefill_s + out.decode_s)
    # the per-call dequantization of an expert stack, the step's largest
    # cost: its one-pass form (models/quant.QuantizedTensor.dequantize)
    # beside the two-pass (q.float() * s).to(bf16), one layer's moe_w1
    from physics_llm_inference_tpu_torch.models.transformer import layer_view

    w = layer_view(params["blocks"], 0)["moe_w1"]
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    one = time_ms(lambda: w.dequantize(torch.bfloat16), flush)
    two = time_ms(lambda: (w.q.float() * w.s).to(torch.bfloat16), flush)
    moved = nbytes(w.q, w.s) + w.q.numel() * 2
    log(f"{what}: dequantizing one expert stack {tuple(w.q.shape)} "
        f"({nvidia_smi()}): one pass {one:.4f} ms, two passes {two:.4f} "
        f"ms, bound {moved / spec.hbm_bandwidth * 1e3:.4f} ms ({moved} "
        f"bytes); {3 * cfg.num_layers} stacks a decode step")
    del flush
    return counts


def moe_bench(dev) -> dict:
    """Phase 5d, part 2: bench/moe.py's two protocols, each JSON on its
    own line. Returns their launches: each main() call as a user makes it,
    its model init, warm run and graph captures included."""
    import torch

    from physics_llm_inference_tpu_torch.bench import moe as bench_moe

    total = {k: 0 for k in KERNELS}
    for argv, need in (([], ("int8_matmul", "int8_kv_decode_attention",
                             "lmhead_greedy", "moe_experts")),
                       (["--engine"], ("int8_matmul", "int8_matmul_prefill",
                                       "int8_kv_decode_attention",
                                       "moe_experts"))):
        t0 = time.perf_counter()
        reset_launches()
        res = bench_moe.main(argv)
        counts = read_launches()
        torch.cuda.empty_cache()
        if any(counts[n] == 0 for n in need) or any(counts[n]
                                                    for n in MOE_FORBID):
            raise AssertionError(f"bench/moe.main({argv}): kernels not "
                                 f"launched as expected: {counts}")
        log(f"bench/moe.main({argv}) ({nvidia_smi()}; "
            f"{time.perf_counter() - t0:.1f} s with its init): "
            f"{json.dumps(res)}; launches "
            f"{({k: v for k, v in counts.items() if v})}")
        total = {k: total[k] + counts[k] for k in KERNELS}
    return total


def moe_engines(dev, params, cfg) -> dict:
    """Phase 5d, part 3: the slot engine (32 slots of 256, INT8 pool,
    horizon 8, bucket 128) captured and with eager dispatch functions on
    the same 32 requests, then the paged engine (INT8 pools of 16-token
    blocks: K6; K5 on the chunks) in both forms: tokens, finish reasons
    and dispatch_trace identical. Returns the captured runs' launches."""
    import gc

    import torch

    from physics_llm_inference_tpu_torch.serve.engine import (EngineConfig,
                                                              InferenceEngine)

    g = torch.Generator().manual_seed(SEED + 13)
    prompts = torch.randint(1, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                            generator=g).tolist()
    ec = EngineConfig(num_slots=MOE_BATCH, max_seq_len=256, kv_dtype="int8",
                      decode_horizon=8, prompt_buckets=(128,))
    runs, counts = {}, None
    for label, cls in (("captured", InferenceEngine),
                       ("eager", eager_slot_engine_class())):
        eng = cls(params, cfg, ec)
        setup = eng.warmup() if label == "captured" else 0.0
        reset_launches()
        runs[label] = direct_run(eng, prompts, 16)
        if label == "captured":
            counts = read_launches()
        log(f"MoE slot engine, {label} ({nvidia_smi()}): warmup() "
            f"{setup:.1f} s; {MOE_BATCH} requests x prompt {MOE_PROMPT} -> "
            f"16 greedy tokens in {runs[label][2]:.3f} s, "
            f"{len(runs[label][1])} dispatches")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    same_run(runs["captured"], runs["eager"], "MoE slot engine")
    need = ("int8_matmul", "int8_matmul_prefill", "int8_kv_decode_attention",
            "moe_experts")
    if any(counts[n] == 0 for n in need) or any(counts[n]
                                                for n in MOE_FORBID):
        raise AssertionError(f"MoE slot engine: kernels not launched as "
                             f"expected: {counts}")
    log(f"MoE slot engine: captured and eager identical (tokens, finish "
        f"reasons, dispatch_trace); launches "
        f"{({k: v for k, v in counts.items() if v})}")
    paged = serve(dev, params, cfg, "MoE paged engine, INT8 pools, BS=16",
                  dict(max_batch=MOE_BATCH, block_size=16,
                       max_blocks_per_request=16,
                       num_blocks=MOE_BATCH * 16 + 16, kv_dtype="int8",
                       decode_horizon=8, prefill_tokens_per_iter=2048),
                  MOE_BATCH, MOE_PROMPT, 16,
                  expect=("int8_paged_decode_attention", "flash_attention",
                          "int8_matmul", "moe_experts"), forbid=MOE_FORBID,
                  compare=True)
    return {k: counts[k] + paged[k] for k in KERNELS}


def moe_runs(dev) -> dict:
    """Phase 5d: the MoE model family at BASELINE config 5's widths. Returns
    the launches of its main-path runs."""
    t0 = time.perf_counter()
    moe_slice_parity(dev)
    moe_engine_parity(dev)
    cfg = moe_cfg(MOE_LAYERS)
    t1 = time.perf_counter()
    params = moe_params(dev, cfg, SEED)
    log(f"MoE init on the card (init_params then quantize_params_int8): "
        f"{time.perf_counter() - t1:.1f} s")
    runs = [moe_full_run(dev, params, cfg), moe_bench(dev),
            moe_engines(dev, params, cfg)]
    del params
    log(f"phase 5d (MoE): {time.perf_counter() - t0:.1f} s")
    return {k: sum(r[k] for r in runs) for k in KERNELS}


# phase 5e: the checkpoint and accuracy path at the CLI's `llama7b` preset
# (LLAMA_7B_CONFIG: 32 layers, 32 q / 32 kv heads, FFN 11008, bf16), on
# weights made from a seed on the card
ACC_SEED = SEED + 14
ACC_WINDOWS, ACC_WINDOW = 64, 256   # perplexity: 64 windows of 256 tokens
ACC_PROMPT = "A checkpoint on disk, read back by the port:"
ACC_TOKENS = 16
# part (c) holds K4 at this call of the decode path (128 cached keys live)
ACC_K4_CALL = 128
ACC_PROBED = kernel_probe.NAMES + ("lmhead_greedy", "fused_decode_step")
# probe_attention_memory's sweeps: the flash branch to 256K positions
# (~2 s there), the naive one until its scores run out of device memory
ACC_FLASH_MAX, ACC_NAIVE_MAX = 1 << 18, 1 << 17


def hf_layout(params, cfg) -> list:
    """`params` in HF Llama naming, as two shards of (name, (out, in) view):
    the embedding and the first half of the layers, then the rest with the
    final norm and the head. Views of `params`: nothing is copied."""
    b = params["blocks"]
    hd, f = cfg.head_dim, cfg.intermediate_dim
    hq, hkv = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def layer(i):
        p, qkv, gu = f"model.layers.{i}.", b["wqkv"][i], b["w_gate_up"][i]
        return [(p + "input_layernorm.weight", b["ln1"][i]),
                (p + "self_attn.q_proj.weight", qkv[:, :hq].t()),
                (p + "self_attn.k_proj.weight", qkv[:, hq:hq + hkv].t()),
                (p + "self_attn.v_proj.weight", qkv[:, hq + hkv:].t()),
                (p + "self_attn.o_proj.weight", b["wo"][i].t()),
                (p + "post_attention_layernorm.weight", b["ln2"][i]),
                (p + "mlp.gate_proj.weight", gu[:, :f].t()),
                (p + "mlp.up_proj.weight", gu[:, f:].t()),
                (p + "mlp.down_proj.weight", b["w_down"][i].t())]

    half = cfg.num_layers // 2
    first = [("model.embed_tokens.weight", params["embed"])]
    second = []
    for i in range(cfg.num_layers):
        (first if i < half else second).extend(layer(i))
    second += [("model.norm.weight", params["norm"]),
               ("lm_head.weight", params["lm_head"].t())]
    return [first, second]


def write_safetensors(shards, path) -> int:
    """Each shard's bf16 tensors as one safetensors file in `path`, written
    here (the card's machine has no safetensors package) one tensor at a
    time through the host: the 8-byte little-endian header length, the
    JSON header padded with spaces to 8 bytes, then each tensor's bytes in
    header order. Returns the bytes written."""
    import os

    import torch

    total = 0
    for k, part in enumerate(shards):
        header, off = {}, 0
        for name, t in part:
            if t.dtype != torch.bfloat16:
                raise AssertionError(f"phase 5e: {name} is {t.dtype}")
            n = t.numel() * t.element_size()
            header[name] = {"dtype": "BF16", "shape": list(t.shape),
                            "data_offsets": [off, off + n]}
            off += n
        head = json.dumps(header).encode()
        head += b" " * (-len(head) % 8)
        name = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        with open(os.path.join(path, name), "wb") as f:
            f.write(len(head).to_bytes(8, "little"))
            f.write(head)
            for _, t in part:
                f.write(t.contiguous().cpu().view(torch.uint8).numpy())
        total += 8 + len(head) + off
    return total


def same_leaves(a, b, what: str) -> int:
    """Every leaf of two parameter trees bit-equal, dtypes and shapes too
    (a QuantizedTensor's q and s each); returns the leaves compared."""
    import torch

    n = 0

    def walk(x, y, key):
        nonlocal n
        if isinstance(x, dict):
            if not isinstance(y, dict) or x.keys() != y.keys():
                raise AssertionError(f"{what}: {key} has other keys")
            for k in x:
                walk(x[k], y[k], f"{key}.{k}")
        elif isinstance(x, tuple):
            if type(x) is not type(y):
                raise AssertionError(f"{what}: {key} is a {type(x).__name__}"
                                     f", not a {type(y).__name__}")
            for name, u, v in zip(x._fields, x, y):
                walk(u, v, f"{key}.{name}")
        else:
            if not (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x, y)):
                raise AssertionError(f"{what}: {key} differs")
            n += 1

    walk(a, b, "params")
    return n


def checkpoint_round_trip(dev, params, cfg, counts: dict) -> tuple:
    """Phase 5e (a): `params` written as bf16 safetensors shards into a
    temporary directory, read back by load_llama (every leaf bit-equal)
    and by load_llama(int8=True) (bit-equal to quantize_params_int8 of
    `params`), and `cli generate --config llama7b --hf DIR --int8` in a
    subprocess, whose text must equal cached_generate's in this process on
    those INT8 weights (and the eager decode loop's tokens, the run the
    kernel probe records, made before it). The launches of cached_generate
    alone, the counts reset just before it and read just after, are added
    to `counts`; it must launch K1 and K3. The directory is removed in
    `finally`, after the subprocess has ended. Returns (the INT8 weights,
    readings)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.models.loader import load_llama
    from physics_llm_inference_tpu_torch.models.quant import \
        quantize_params_int8
    from physics_llm_inference_tpu_torch.runtime.generate import \
        cached_generate
    from physics_llm_inference_tpu_torch.serve.tokenizer_pool import \
        TokenizerPool

    shards = hf_layout(params, cfg)
    need = sum(t.numel() * t.element_size() for part in shards
               for _, t in part)
    tmp = tempfile.mkdtemp(prefix="pli_hf_")
    proc, r = None, {}
    try:
        free = shutil.disk_usage(tmp).free
        if free < need + (1 << 30):
            raise AssertionError(f"phase 5e: the checkpoint needs {need} "
                                 f"bytes and 1 GiB to spare; {tmp} has "
                                 f"{free} bytes free")
        t0 = time.perf_counter()
        r["bytes"] = write_safetensors(shards, tmp)
        r["write_s"] = time.perf_counter() - t0
        del shards
        t_cli = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.cli", "generate", "--config",
             "llama7b", "--hf", tmp, "--int8", "--prompt", ACC_PROMPT,
             "--max-tokens", str(ACC_TOKENS)], cwd=ROOT,
            env=dict(os.environ, PYTHONIOENCODING="utf-8"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_llama(tmp, cfg, device=dev)
        torch.cuda.synchronize()
        r["load_s"] = time.perf_counter() - t0
        r["leaves"] = same_leaves(loaded, params, "load_llama")
        del loaded
        torch.cuda.empty_cache()   # the subprocess loads the same 13.5 GB
        t0 = time.perf_counter()
        q_loaded = load_llama(tmp, cfg, int8=True, device=dev)
        torch.cuda.synchronize()
        r["load_int8_s"] = time.perf_counter() - t0
        q8 = quantize_params_int8(params)
        same_leaves(q_loaded, q8, "load_llama(int8=True)")
        del q_loaded
        torch.cuda.empty_cache()
        tok = TokenizerPool(num_workers=1)
        prompt = tok.tokenize(ACC_PROMPT)
        eager, _, _ = eager_decode(q8, cfg, [prompt], True, None, ACC_TOKENS,
                                   kv_dtype=None)
        torch.cuda.synchronize()
        reset_launches()
        out = cached_generate(q8, cfg, [prompt], ACC_TOKENS,
                              generator=torch.Generator(device=dev)
                              .manual_seed(0), temperature=0.0)
        torch.cuda.synchronize()
        r["launches"] = c = read_launches()
        for k in KERNELS:
            counts[k] += c[k]
        if not (c["int8_matmul"] and c["lmhead_greedy"]):
            raise AssertionError(f"phase 5e (a): cached_generate launched "
                                 f"{c}")
        if not np.array_equal(out.tokens, eager):
            raise AssertionError(f"phase 5e: cached_generate {out.tokens} "
                                 f"against the eager loop's {eager}")
        text = tok.detokenize([int(t) for t in out.tokens[0]])
        stdout, stderr = proc.communicate(timeout=600)
        r["cli_s"] = time.perf_counter() - t_cli
        if proc.returncode != 0:
            raise AssertionError(f"phase 5e: cli generate --hf exited "
                                 f"{proc.returncode}: "
                                 f"{stderr.decode(errors='replace')[-3000:]}")
        got = stdout.decode("utf-8")
        if got != text + "\n":
            raise AssertionError(f"phase 5e: cli generate --hf printed "
                                 f"{got!r}, cached_generate here {text!r}")
        r["tokens"] = out.tokens[0].tolist()
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 5e (a) HF checkpoint round trip, {cfg.num_layers} layers "
        f"({nvidia_smi()}): {r['bytes']} bytes in 2 bf16 safetensors "
        f"shards written in {r['write_s']:.2f} s; load_llama "
        f"{r['load_s']:.2f} s, {r['leaves']} leaves bit-equal; "
        f"load_llama(int8=True) {r['load_int8_s']:.2f} s, bit-equal to "
        f"quantize_params_int8; cli generate --hf --int8 (a subprocess, "
        f"{r['cli_s']:.1f} s from its start) printed the text of "
        f"cached_generate here, tokens {r['tokens']} (the eager loop's "
        f"too); cached_generate's launches "
        f"{ {k: n for k, n in r['launches'].items() if n} }")
    return q8, r


def accuracy_perplexity(dev, params, q8, cfg, counts: dict) -> dict:
    """Phase 5e (b): perplexity and decode_path_perplexity on the bf16
    weights (bf16 cache), within 2% of each other (tests/
    test_loader_eval.py's rule); decode_path_perplexity in W8A16, W4A16
    (round to nearest and MSE scales) and W8A8, each over an INT8 cache,
    K4's launch counts reset before each mode and read after it: one
    launch a one-token forward (window - 1), in that mode alone; then
    quantization_ppl_report. Each part's launches are added to
    `counts`. Returns the perplexities."""
    import dataclasses

    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.bench.perplexity import (
        decode_path_perplexity, perplexity, quantization_ppl_report)
    from physics_llm_inference_tpu_torch.models.quant import \
        quantize_params_int4

    toks = np.random.default_rng(ACC_SEED).integers(
        0, cfg.vocab_size, ACC_WINDOWS * ACC_WINDOW)
    k4 = [FUSED_MODES[m][2] for m in FUSED_MODES]

    def counted(fn):
        reset_launches()
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = read_launches()
        for k in KERNELS:
            counts[k] += c[k]
        return val, c, secs

    out, notes = {}, []
    out["forward bf16"], _, s = counted(
        lambda: perplexity(params, cfg, toks, window=ACC_WINDOW))
    notes.append(f"parallel forward bf16 {out['forward bf16']:.4f} "
                 f"({s:.1f} s)")
    out["decode bf16"], c, s = counted(
        lambda: decode_path_perplexity(params, cfg, toks, window=ACC_WINDOW))
    rel = abs(out["decode bf16"] - out["forward bf16"]) / out["forward bf16"]
    if rel >= 0.02 or any(c[n] for n in k4):
        raise AssertionError(f"phase 5e: decode path bf16 "
                             f"{out['decode bf16']:.4f} against the parallel "
                             f"forward's {out['forward bf16']:.4f} (rel "
                             f"{rel:.4g}, rule < 2e-2); K4 launches "
                             f"{ {n: c[n] for n in k4} }")
    notes.append(f"decode path bf16 (bf16 cache, per-op) "
                 f"{out['decode bf16']:.4f} ({s:.1f} s), {rel:.4g} from the "
                 "forward's (< 2e-2)")
    steps = ACC_WINDOW - 1
    modes = (("w8a16", "w8a16", None), ("w4a16", "w4a16", False),
             ("w4a16 mse", "w4a16", True), ("w8a8", "w8a8", None))
    for label, mode, mse in modes:
        weights = q8 if mse is None else quantize_params_int4(params, mse=mse)
        cfg_m = dataclasses.replace(cfg, act_quant=FUSED_MODES[mode][1])
        out[label], c, s = counted(lambda: decode_path_perplexity(
            weights, cfg_m, toks, window=ACC_WINDOW, kv_dtype=torch.int8))
        del weights
        want = {n: steps if n == FUSED_MODES[mode][2] else 0 for n in k4}
        got = {n: c[n] for n in k4}
        if got != want:
            raise AssertionError(f"phase 5e: decode path {label}: K4 "
                                 f"launches {got}, expected {want}")
        notes.append(f"decode path {label.upper()} (INT8 cache) "
                     f"{out[label]:.4f}, {out[label] - out['decode bf16']:+.4f}"
                     f" from bf16 ({s:.1f} s; K4 {steps} launches in "
                     f"{steps} one-token forwards, "
                     f"{s / steps * 1e3:.2f} ms each)")
    rep, _, s = counted(lambda: quantization_ppl_report(
        params, q8, cfg, toks, window=ACC_WINDOW))
    out["report"] = rep
    notes.append(f"quantization_ppl_report (W8A16, parallel forward) {rep} "
                 f"({s:.1f} s)")
    log(f"phase 5e (b) perplexity, {ACC_WINDOWS} windows of {ACC_WINDOW} "
        f"random tokens (seed {ACC_SEED}), random weights: near the "
        f"vocabulary size, so the deltas say nothing of accuracy "
        f"({nvidia_smi()}): " + "; ".join(notes))
    return out


def ptxas_resources(reports: dict, pattern: str) -> tuple:
    """(registers, bytes of static shared memory) ptxas reported for the
    one kernel entry whose mangled name contains `pattern`."""
    import re

    found, cur = [], None
    for text in reports.values():
        for ln in text.splitlines():
            if m := re.search(r"Compiling entry function '(\w+)'", ln):
                cur = m.group(1)
            elif (m := re.search(r"Used (\d+) registers", ln)) and cur \
                    and pattern in cur:
                smem = re.search(r"(\d+) bytes smem", ln)
                found.append((int(m.group(1)),
                              int(smem.group(1)) if smem else 0))
                cur = None
    if len(found) != 1:
        raise AssertionError(f"ptxas report: {len(found)} entries match "
                             f"{pattern!r}")
    return found[0]


def occupancy_readings(reports: dict) -> str:
    """Phase 5e (e): the occupancy model (specs/occupancy.py) for K5's
    head_dim-128 launch and K7's launch, from ptxas's registers and static
    shared memory (phase 2) and the block's threads and dynamic shared
    memory (the library's `_block` queries), held to the CUDA runtime's
    own count of resident blocks an SM."""
    from physics_llm_inference_tpu_torch.kernels import _build
    from physics_llm_inference_tpu_torch.specs.occupancy import occupancy

    parts = []
    for label, entry, pattern in (
            ("K5 flash_attention_kernel<8>", "pli_flash_attention",
             "22flash_attention_kernelILi8E"),
            ("K7 paged_attention_kernel", "pli_paged_decode_attention",
             "22paged_attention_kernel")):
        threads, dynamic, runtime = _build.block_shape(entry)
        regs, static = ptxas_resources(reports, pattern)
        o = occupancy(threads, regs, static + dynamic)
        said = (f"{label}: {threads} threads, {regs} registers, "
                f"{static} + {dynamic} bytes of shared memory -> "
                f"{o['blocks_per_sm']} blocks an SM ({o['warps_per_sm']} "
                f"warps, occupancy {o['occupancy']:.4f}), bound by "
                f"{o['limit']} (limits {o['limits']}); the CUDA runtime "
                f"says {runtime}")
        if o["blocks_per_sm"] != runtime:
            raise AssertionError(f"phase 5e (e): the occupancy model "
                                 f"disagrees with the runtime: {said}")
        parts.append(said)
    return "; ".join(parts)


def attention_probe(dev, counts: dict) -> str:
    """Phase 5e (d): probe_attention_memory's flash branch (K5) to
    ACC_FLASH_MAX positions and its naive branch until its scores run out
    of device memory (B 1, 32 heads, head_dim 128, bf16), each S with its
    predicted bytes; K5 then held against its plain version at S = 4,096
    on the probe's own inputs (flash_err)."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import flash_attention as kfa
    from physics_llm_inference_tpu_torch.ops.attention import \
        probe_attention_memory

    kw = dict(batch=1, heads=32, head_dim=128, start_seq=1024, device=dev)
    parts, res = [], {}
    for flash, top in ((True, ACC_FLASH_MAX), (False, ACC_NAIVE_MAX)):
        reset_launches()
        t0 = time.perf_counter()
        res[flash] = r = probe_attention_memory(max_seq=top, flash=flash,
                                                **kw)
        secs = time.perf_counter() - t0
        c = read_launches()
        for k in KERNELS:
            counts[k] += c[k]
        parts.append(f"{'flash (K5)' if flash else 'naive'} {secs:.1f} s, "
                     f"K5 launches {c['flash_attention']}: "
                     + ", ".join(f"S {x['seq']} " + (
                         f"ok, {x['predicted_bytes']} bytes predicted"
                         if x["ok"] else f"failed ({x['error']})")
                         for x in r["results"])
                     + f"; max_ok {r['max_ok']}")
    if (res[True]["failed_at"] is not None
            or res[True]["max_ok"] != ACC_FLASH_MAX
            or res[False]["failed_at"] is None
            or not res[False]["max_ok"] < res[True]["max_ok"]):
        raise AssertionError("phase 5e (d): the flash sweep should reach "
                             f"{ACC_FLASH_MAX} and the naive one run out of "
                             f"memory below it: {parts}")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, 32, 4096, 128), generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in "qkv")
    err = flash_err(kfa, (q, k, v), {"causal": True}, "probe S=4096")
    return " | ".join(parts) + f"; K5 at S 4096 against its plain version " \
        f"{err:.4g} (2e-2)"


def accuracy_runs(dev, reports: dict) -> dict:
    """Phase 5e: the checkpoint and accuracy path at LLAMA_7B_CONFIG's
    widths: (a) checkpoint_round_trip, (b) accuracy_perplexity, (c) every
    kernel they launched held against its plain version on the inputs the
    path gave it (kernel_probe: K1 on each route, K3, K4 in each mode at
    its ACC_K4_CALL-th decode-path call), (d) attention_probe, (e)
    occupancy_readings. Returns the launch counts of (a)'s
    cached_generate, (b)'s runs and (d)'s sweeps: the eager loop and the
    probe's comparisons left out."""
    import torch

    from physics_llm_inference_tpu_torch.models.config import LLAMA_7B_CONFIG
    from physics_llm_inference_tpu_torch.models.transformer import init_params

    t0 = time.perf_counter()
    cfg = LLAMA_7B_CONFIG
    counts = {k: 0 for k in KERNELS}
    params = init_params(torch.Generator(device=dev).manual_seed(ACC_SEED),
                         cfg)
    with kernel_probe(ACC_PROBED, at={"fused_decode_step": ACC_K4_CALL}) \
            as probe:
        q8, _ = checkpoint_round_trip(dev, params, cfg, counts)
        accuracy_perplexity(dev, params, q8, cfg, counts)
    kinds = probe.kinds()
    want = {("lmhead_greedy", None, None)} | {
        ("fused_decode_step", m, None) for m in FUSED_MODES} | {
        ("int8_matmul", r, cfg.hidden_dim) for r in ("stream", "wgmma")}
    if not want <= kinds:
        raise AssertionError(f"phase 5e (c): the probe saw {sorted(kinds)}")
    log(f"phase 5e (c) the kernels on the path's own inputs against their "
        f"plain versions ({nvidia_smi()}): {probe.check('phase 5e')}")
    del probe, params, q8
    release()
    log(f"phase 5e (d) probe_attention_memory ({nvidia_smi()}): "
        f"{attention_probe(dev, counts)}")
    torch.cuda.empty_cache()
    log(f"phase 5e (e) occupancy: {occupancy_readings(reports)}")
    log(f"phase 5e (accuracy path): {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}")
    return counts


SUITE_KEYS = ("mha_vs_gqa", "swiglu_fusion", "naive_vs_cached", "gemm",
              "gemv_bf16", "gemv_int8", "attn_flash", "attn_naive",
              "static_batching")


def fractions(tree):
    """Every roofline_fraction in a nested result."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "roofline_fraction":
                yield v
            else:
                yield from fractions(v)


def micro_path(dev) -> dict:
    """Phase 6: the microbenchmark path through its public functions at the
    JAX package's default sizes, then the suite in full. Returns the launch
    counts of the run."""
    import math

    import torch

    from physics_llm_inference_tpu_torch.bench import micro, suite
    from physics_llm_inference_tpu_torch.kernels.hello_pallas import \
        vector_add
    from physics_llm_inference_tpu_torch.kernels.membench import \
        measure_access_patterns

    t0 = time.perf_counter()
    reset_launches()
    res = {
        "gemm_kernel": micro.bench_gemm(use_kernel=True),
        "gemm": micro.bench_gemm(),
        "gemv_bf16": micro.bench_gemv(8, 4096, 4096),
        "gemv_int8": micro.bench_gemv(8, 4096, 4096, int8_weights=True),
        "attn_flash": micro.bench_attention(seq=2048),
        "attn_naive": micro.bench_attention(seq=2048, use_flash=False),
        "precision": micro.bench_precision(),
        "access_patterns": measure_access_patterns(),
    }
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    a = torch.randn((524288, 128), generator=g, device=dev)
    if not torch.equal(vector_add(a, a), a + a):
        raise AssertionError("phase 6: vector_add differs from a + a")
    for name, r in res.items():
        log(f"phase 6 {name}: {json.dumps(r, default=float)}")
    log(micro.roofline_report([res[k] for k in ("gemm_kernel", "gemm",
                                                "gemv_bf16", "gemv_int8",
                                                "attn_flash", "attn_naive")]))
    res["suite"] = suite.main([])
    counts = read_launches()
    log(f"phase 6 (microbenchmark path): {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}")
    missing = [k for k in MICRO_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"phase 6: kernels not launched: {missing}")
    if set(res["suite"]) != set(SUITE_KEYS):
        raise AssertionError(f"phase 6: suite keys {sorted(res['suite'])}")
    values = list(fractions(res))
    if not values or not all(math.isfinite(v) and 0 < v <= 1.05
                             for v in values):
        raise AssertionError(f"phase 6: roofline fractions {values} outside "
                             "(0, 1.05]: the bytes or operations counted are "
                             "wrong")
    return counts


def serving_alone(dev):
    """The first of serving_runs alone: the bench_serving7b wave, with K1's
    census and the profiled wave."""
    import torch

    from physics_llm_inference_tpu_torch.models.quant import init_params_int8

    cfg = serving_cfg()
    bench_wave(dev, init_params_int8(
        torch.Generator(device=dev).manual_seed(SEED), cfg), cfg)


# ------------------------------------------------------------- phase 5f

# Phase 5f: the parallel layer, two ranks sharing the one card over gloo
# (a shared-card correctness run: it measures no scaling)
PAR_B, PAR_PROMPT, PAR_LONG, PAR_TOKENS = 8, 128, 512, 32
PAR_REQUESTS, PAR_REQ_PROMPT, PAR_REQ_TOKENS, PAR_CHATS = 16, 576, 32, 4
PAR_FORCED = 8     # (c)'s requests teacher-forced through the paged steps
PAR_SEED = SEED + 15
# the TP rule: first-step logits within PAR_LOGIT_REL of the reference's
# largest logit, and greedy tokens identical up to the first position where
# the reference's top-two logit gap is below PAR_MARGIN
PAR_LOGIT_REL, PAR_MARGIN = 3e-2, 0.1
PAR_PG_TIMEOUT_S = 600     # a rank waiting longer fails the phase
PAR_DEVICE = "cuda:0"      # both ranks' device: the one card
PAR_LAYERS = 32
RING = dict(b=1, hq=32, hkv=8, hd=128, s=8192)


def tree_digest(tree) -> str:
    """A digest of every byte of a parameter tree, on the device: each leaf's
    bytes, as int64, dotted with pseudo-random int64 weights from a fixed
    seed (wrapping sums), chunk by chunk; the sums' sha256. Two ranks'
    trees agree where their digests do."""
    import hashlib

    import torch

    def leaves(t):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k])
        elif isinstance(t, tuple):
            for x in t:
                yield from leaves(x)
        else:
            yield t

    h, chunk = hashlib.sha256(), 1 << 26
    for t in leaves(tree):
        flat = t.contiguous().view(-1).view(torch.uint8)
        g = torch.Generator(device=flat.device).manual_seed(1234)
        acc = torch.zeros((), dtype=torch.int64, device=flat.device)
        for i in range(0, flat.numel(), chunk):
            part = flat[i:i + chunk].to(torch.int64)
            w = torch.randint(-(1 << 62), 1 << 62, part.shape,
                              generator=g, device=flat.device,
                              dtype=torch.int64)
            acc += (part * w).sum()
        h.update(str(int(acc)).encode())
    return h.hexdigest()[:16]


def spawn_ranks(fn_name: str, world: int, backend: str, *args,
                timeout: float = 900) -> list:
    """fn_name(rank, world, mesh_backend, *args) of this script on `world`
    spawned processes sharing the card, one process group over `backend`
    (file-initialized, PAR_PG_TIMEOUT_S a wait). Returns each rank's
    result; a rank that raises, hangs or dies fails the phase."""
    import multiprocessing as mp
    import pickle
    import tempfile

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, backend, str(out / "pg"), fn_name, args, tmp))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
        errs = {r: (out / f"{r}.err").read_text() for r in range(world)
                if (out / f"{r}.err").exists()}
        codes = [p.exitcode for p in procs]
        if hung or errs or any(codes):
            raise AssertionError(f"phase 5f {fn_name}: ranks hung {hung}, "
                                 f"exit codes {codes}, errors {errs}")
        return [pickle.loads((out / f"{r}.pkl").read_bytes())
                for r in range(world)]


def _rank_main(rank, world, backend, init_file, fn_name, args, out_dir):
    """A spawned rank: the process group, then fn_name; its result or its
    traceback to out_dir."""
    import datetime
    import pickle
    import traceback

    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PAR_PG_TIMEOUT_S))
        res = globals()[fn_name](rank, world, backend, *args)
        Path(out_dir, f"{rank}.pkl").write_bytes(pickle.dumps(res))
    except BaseException:
        Path(out_dir, f"{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def nccl_world(rank, world, backend):
    """Part (a): make_mesh(model=1) on nccl in a world of one, one of each
    collective on device tensors (each the identity on one rank)."""
    import torch

    from physics_llm_inference_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh(model=1, backend="nccl")
    x = torch.arange(64, dtype=torch.bfloat16,
                     device=mesh.device).reshape(8, 8)
    got = {"all_reduce": mesh.all_reduce(x, "model"),
           "all_gather": mesh.all_gather(x, "model", dim=1),
           "all_to_all": mesh.all_to_all(x, "model", 0, 1),
           "ring_shift": mesh.ring_shift(x, "model"),
           "broadcast": mesh.broadcast(x, "model")}
    torch.cuda.synchronize()
    bad = [k for k, v in got.items() if not (v.is_cuda and torch.equal(v, x))]
    if bad:
        raise AssertionError(f"phase 5f (a): nccl collectives not the "
                             f"identity on one rank: {bad}")
    return {"transport": mesh.transport, "device": str(mesh.device),
            "s": time.perf_counter() - t0}


def _gaps(logits):
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def greedy_tp(params, cfg, prompts, steps: int, mesh=None) -> dict:
    """Prefill `prompts` (B, P) into an INT8 cache through forward, then
    steps - 1 greedy decode steps: the first step's logits (B, V), the
    tokens and the top-two gaps (B, steps), and the decode's ms a step and
    share of it in the mesh's collectives."""
    import torch

    from physics_llm_inference_tpu_torch.models.transformer import forward
    from physics_llm_inference_tpu_torch.runtime.kv_cache import KVCache

    dev = prompts.device
    b, p = prompts.shape
    cache = KVCache.create(cfg, b, p + steps, dtype=torch.int8, device=dev)
    logits, kv = forward(params, prompts, cfg, kv=cache.as_slice(),
                         last_only=True)
    first = logits[:, -1].float()
    toks, gaps = [first.argmax(-1)], [_gaps(first)]
    torch.cuda.synchronize()
    if mesh is not None:
        mesh.time_collectives()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        logits, kv = forward(params, toks[-1][:, None], cfg, kv=kv,
                             last_only=True)
        toks.append(logits[:, -1].argmax(-1))
        gaps.append(_gaps(logits[:, -1]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    share = None
    if mesh is not None:
        share = mesh.comm_s / wall
        mesh.time_collectives(False)
    return {"first": first.cpu().numpy(),
            "tokens": torch.stack(toks, 1).cpu().numpy(),
            "gaps": torch.stack(gaps, 1).cpu().numpy(),
            "ms": wall / max(1, steps - 1) * 1e3, "share": share}


def tp_rule(ref: dict, got: dict, what: str) -> str:
    """The TP rule on one run: first-step logits within PAR_LOGIT_REL of
    the reference's largest logit, tokens identical up to the first
    position where the reference's top-two gap is below PAR_MARGIN.
    Raises AssertionError when broken; returns the readings."""
    import numpy as np

    rel = float(np.abs(got["first"] - ref["first"]).max()
                / np.abs(ref["first"]).max())
    if not (np.isfinite(got["first"]).all() and rel <= PAR_LOGIT_REL):
        raise AssertionError(f"{what}: first-step logits off by {rel:.4g} "
                             f"of the largest (> {PAR_LOGIT_REL})")
    held, full = 0, 0
    if "tokens" in ref:
        for r in range(ref["tokens"].shape[0]):
            tie = np.nonzero(ref["gaps"][r] < PAR_MARGIN)[0]
            upto = int(tie[0]) if tie.size else ref["tokens"].shape[1]
            if not np.array_equal(got["tokens"][r, :upto],
                                  ref["tokens"][r, :upto]):
                raise AssertionError(
                    f"{what}: row {r} differs before its first near-tie "
                    f"(position {upto}): {got['tokens'][r].tolist()} vs "
                    f"{ref['tokens'][r].tolist()}")
            held += upto
            full += int(np.array_equal(got["tokens"][r], ref["tokens"][r]))
    return (f"{what}: logits rel {rel:.4g} (<= {PAR_LOGIT_REL}); tokens held "
            f"at {held} positions before near-ties (gap < {PAR_MARGIN}), "
            f"{full} rows identical throughout")


def rule_breaks(rule, ref, got, what: str) -> str:
    """A control must break `rule` (tp_rule or logits_rule)."""
    try:
        rule(ref, got, what)
    except AssertionError as e:
        return f"{what} breaks the rule ({e})"
    raise AssertionError(f"phase 5f: the control {what} passes the rule")


class skip_wo_reduce:
    """Control: on `rank`, every wo all-reduce is issued (so the other
    ranks do not wait forever) but its sum is dropped for the rank's own
    partial product. forward's all-reduces come in a fixed order, the
    embedding's first, then wo and down of each layer."""

    def __init__(self, rank: int, on_rank: int):
        self.active = rank == on_rank

    def __enter__(self):
        from physics_llm_inference_tpu_torch.models import transformer as tf

        self.tf, self.orig = tf, (tf._tp_psum, tf.embed_lookup)
        if not self.active:
            return self
        n = [0]

        def psum(y, cfg):
            out = self.orig[0](y, cfg)
            n[0] += 1
            return y if n[0] % 2 == 0 else out   # 2, 4, ...: each wo

        def embed(*a):
            n[0] = 0
            return self.orig[1](*a)

        tf._tp_psum, tf.embed_lookup = psum, embed
        return self

    def __exit__(self, *exc):
        self.tf._tp_psum, self.tf.embed_lookup = self.orig


class skip_paged_wo_reduce:
    """Controls of (c): on `rank`, the paged model's wo all-reduce at one
    of its two `_tp_psum` sites (`site`: the prefill chunk's or the
    decode step's) is issued but its sum dropped for the rank's own
    partial product; the other site, the FFN's and the embedding's stay
    whole."""

    FNS = {"prefill": "paged_prefill_chunk_impl",
           "decode": "_paged_decode_step_impl"}

    def __init__(self, rank: int, on_rank: int, site: str):
        self.active, self.fn = rank == on_rank, self.FNS[site]

    def __enter__(self):
        from physics_llm_inference_tpu_torch.models import \
            paged_transformer as pt

        self.pt, self.orig = pt, pt._tp_psum
        if self.active:
            def psum(y, cfg):
                out = self.orig(y, cfg)
                return y if sys._getframe(1).f_code.co_name == self.fn \
                    else out

            pt._tp_psum = psum
        return self

    def __exit__(self, *exc):
        self.pt._tp_psum = self.orig


def paged_wave(eng, prompts, tokens: int) -> dict:
    """Every prompt at once through a paged engine, greedy: tokens, finish
    reasons, dispatch_trace and the wall."""
    import torch

    from physics_llm_inference_tpu_torch.serve.lifecycle import \
        GenerationRequest

    eng.dispatch_trace = []
    t0 = time.perf_counter()
    rids = [eng.submit_request(GenerationRequest(
        prompt_tokens=list(p), max_tokens=tokens, temperature=0.0,
        request_id=f"p{i}")) for i, p in enumerate(prompts)]
    eng.run_until_done(rids)
    torch.cuda.synchronize()
    res = [eng.get_result(r) for r in rids]
    return {"tokens": [list(map(int, r.tokens)) for r in res],
            "reasons": [r.finish_reason for r in res],
            "trace": [tuple(x) for x in eng.dispatch_trace],
            "s": time.perf_counter() - t0}


def decode_clock(eng, mesh) -> dict:
    """Wrap the engine's decode dispatch: the returned dict fills in with
    the decode steps run, their ms a step (host clock, the device
    synchronized) and the share of it in the mesh's collectives (which
    counts only while the mesh counts)."""
    import torch

    acc = {"steps": 0, "s": 0.0, "comm_s": 0.0}
    inner = eng._decode

    def timed(horizon, *a, **kw):
        torch.cuda.synchronize()
        c0, t0 = mesh.comm_s or 0.0, time.perf_counter()
        out = inner(horizon, *a, **kw)
        torch.cuda.synchronize()
        acc["s"] += time.perf_counter() - t0
        acc["comm_s"] += (mesh.comm_s or 0.0) - c0
        acc["steps"] += horizon
        res["step_ms"] = acc["s"] / acc["steps"] * 1e3
        res["step_share"] = acc["comm_s"] / acc["s"]
        res["steps"] = acc["steps"]
        return out

    res = {}
    eng._decode = timed
    return res


def forced_gaps(params, cfg, prompts, tokens) -> list:
    """The reference's top-two gaps at each generated position, from one
    teacher-forced forward over prompt + its tokens (an engine returns no
    logits): an approximation of the engine's own decode logits."""
    import torch

    from physics_llm_inference_tpu_torch.models.transformer import forward

    out = []
    for p, t in zip(prompts, tokens):
        ids = torch.tensor([list(p) + list(t[:-1])],
                           device=params["embed"].device)
        logits, _ = forward(params, ids, cfg)
        out.append(_gaps(logits[0, len(p) - 1:]).cpu().numpy())
        del logits
    return out


def forced_paged_logits(eng, prompts, tokens, steps: int | None = None
                        ) -> dict:
    """Teacher-force each prompt and its reference tokens through the
    paged model's step functions on `eng`'s own params and step config
    (a TP engine's shard and local config): the prompt in prefill chunks
    of the engine's max_prefill_chunk (paged_prefill_chunk_impl), then one
    per-op decode step a reference token (paged_decode_step), over fresh
    INT8 pools of the engine's block geometry. Returns the logits at each
    of `steps` (default all) generated positions, (R, T, V) f32, and their
    top-two gaps (R, T)."""
    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.models.paged_transformer import (
        paged_decode_step, paged_prefill_chunk_impl)
    from physics_llm_inference_tpu_torch.models.transformer import QuantKV

    c, cfg, dev = eng.config, eng._run_cfg, eng.device
    r, p = len(prompts), len(prompts[0])
    t = len(tokens[0]) if steps is None else steps
    mb, bs = c.max_blocks_per_request, c.block_size
    hkv = cfg.num_kv_heads * cfg.head_dim
    pools = QuantKV(
        q=torch.zeros((cfg.num_layers, r * mb + 1, 2, bs, hkv),
                      dtype=torch.int8, device=dev),
        s=torch.zeros((cfg.num_layers, r * mb + 1, 2, cfg.num_kv_heads, bs),
                      dtype=torch.float32, device=dev))
    tables = torch.arange(r * mb, dtype=torch.int32,
                          device=dev).reshape(r, mb)
    ids = torch.tensor(np.asarray(prompts), device=dev)
    forced = torch.tensor(np.asarray(tokens)[:, :t], device=dev)
    for start in range(0, p, c.max_prefill_chunk):
        chunk = ids[:, start:start + c.max_prefill_chunk]
        logits, pools, _ = paged_prefill_chunk_impl(
            eng.params, chunk, pools, None, tables,
            torch.full((r,), start, device=dev),
            torch.full((r,), chunk.shape[1], device=dev), cfg)
    out = [logits.float()]
    for i in range(t - 1):
        logits, pools, _ = paged_decode_step(
            eng.params, forced[:, i], pools, None, tables,
            torch.full((r,), p + i, dtype=torch.int32, device=dev), cfg)
        out.append(logits.float())
    logits = torch.stack(out, 1)
    res = {"logits": logits.cpu().numpy(),
           "gaps": _gaps(logits).cpu().numpy()}
    del pools, logits, out
    return res


def position_rel(ref, got):
    """Each position's largest logit error over its (R, V) logits, over
    the reference's largest logit there: (T,)."""
    import numpy as np

    return (np.abs(got - ref).max(axis=(0, 2))
            / np.abs(ref).max(axis=(0, 2)))


def logits_rule(ref, got, what: str) -> str:
    """The TP rule's logits half at every position of a teacher-forced run:
    at each position, the (R, V) logits within PAR_LOGIT_REL of the
    reference's largest there. Raises AssertionError when broken; returns
    the readings."""
    import numpy as np

    rel = position_rel(ref, got)
    worst = int(rel.argmax())
    if not (np.isfinite(got).all() and rel[worst] <= PAR_LOGIT_REL):
        raise AssertionError(f"{what}: logits at position {worst} off by "
                             f"{rel[worst]:.4g} of the largest (> "
                             f"{PAR_LOGIT_REL})")
    return (f"{what}: logits at all {rel.size} positions of {got.shape[0]} "
            f"requests within {rel[worst]:.4g} of the largest (worst at "
            f"position {worst}, median {float(np.median(rel)):.4g}; <= "
            f"{PAR_LOGIT_REL})")


def engine_rule(ref_tokens, gaps, got_tokens, what: str) -> str:
    """Each request's tokens identical up to the first position where the
    reference's (teacher-forced) top-two gap is below PAR_MARGIN."""
    import numpy as np

    held, full = 0, 0
    for i, (want, g, got) in enumerate(zip(ref_tokens, gaps, got_tokens)):
        tie = np.nonzero(np.asarray(g) < PAR_MARGIN)[0]
        upto = int(tie[0]) if tie.size else len(want)
        if list(got[:upto]) != list(want[:upto]):
            raise AssertionError(f"{what}: request {i} differs before its "
                                 f"first near-tie (position {upto})")
        held += upto
        full += int(list(got) == list(want))
    return (f"{what}: tokens held at {held} positions before near-ties, "
            f"{full}/{len(ref_tokens)} requests identical throughout")


# speculative decoding against the plain engine: the two emitted tokens at a
# request's first differing position within SPEC_TIE_REL of the reference's
# largest logit there (each path within PAR_LOGIT_REL of the reference)
SPEC_TIE_REL = 2 * PAR_LOGIT_REL


def spec_ties(params, cfg, prompts, plain, spec, what: str) -> str:
    """Greedy tokens with speculative decoding (`spec`) against the plain
    engine's (`plain`) on the same prompts. The verify window's logits come
    from the per-op forward, the plain engine's from K4, whose residual
    stream stays f32, so a token may flip where the two paths are near a
    tie. At each request's first differing position one teacher-forced
    forward (per-op, over the prompt and the tokens both emitted) gives the
    reference's logits there: the plain token's logit less the speculative
    one's must lie within SPEC_TIE_REL of the largest logit, so a verify
    window that accepts a draft the model does not rank at the top fails.
    The same number of tokens is held. Logs each such position with the
    reference's top-two gap; raises AssertionError, returns the line."""
    import torch

    from physics_llm_inference_tpu_torch.models.transformer import forward

    same, ties, bad = 0, [], 0
    for p, a, b in zip(prompts, plain, spec):
        a, b = list(a), list(b)
        if len(a) != len(b):
            raise AssertionError(f"{what}: speculation emitted {len(b)} "
                                 f"tokens against the plain engine's "
                                 f"{len(a)}")
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            same += 1
            continue
        ids = torch.tensor([list(p) + a[:j]], device=params["embed"].device)
        with torch.no_grad():
            logits, _ = forward(params, ids, cfg)
        lg = logits[0, -1].float()
        top = lg.topk(2).values
        d = float(lg[a[j]] - lg[b[j]])
        bound = SPEC_TIE_REL * float(lg.abs().max())
        bad += abs(d) > bound
        ties.append(f"({j}, {float(top[0] - top[1]):.4f}, {d:+.4f}, "
                    f"{bound:.4f})")
        del logits
    line = (f"{what}: requests with the plain engine's tokens {same} of "
            f"{len(prompts)}; at each other's first differing position "
            "(position, the reference's top-two gap, the plain token's "
            "logit less the speculative one's, the bound "
            f"{SPEC_TIE_REL:g} of the largest logit): " + (", ".join(ties)
                                                          or "none"))
    if bad:
        raise AssertionError(f"{line}: {bad} beyond the bound")
    return line


def tp_world(rank, world, backend):
    """Parts (b), (c), (e), (f) and (g) on this rank of two sharing the
    card over gloo. Rank 0 also runs the single-process references on the
    full weights. Returns this rank's readings (the parent holds them to
    the rules)."""
    import dataclasses

    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import (
        QuantizedTensor, init_params_int8)
    from physics_llm_inference_tpu_torch.parallel import (
        make_mesh, tp_local_config, tp_prepare_params)
    from physics_llm_inference_tpu_torch.serve.paged_engine import (
        PagedEngineConfig, PagedInferenceEngine)

    dev = torch.device(PAR_DEVICE)
    out = {"rank": rank}
    try:
        make_mesh(model=2, backend="nccl", device=dev)
        raise AssertionError("nccl with two ranks on one card was accepted")
    except ValueError as e:
        out["nccl_refusal"] = str(e)
    mesh = make_mesh(model=2, backend="gloo", device=dev)
    out["transport"] = mesh.transport

    # (b) the bench.py 7B GQA model at full width, INT8 weights and KV
    t0 = time.perf_counter()
    cfg = dataclasses.replace(ModelConfig(num_layers=PAR_LAYERS, **WIDTHS),
                              fused_decode=False)
    full = init_params_int8(torch.Generator(device=dev).manual_seed(PAR_SEED),
                            cfg)
    out["digest"] = tree_digest(full)
    g = torch.Generator(device=dev).manual_seed(PAR_SEED + 1)
    prompts = torch.randint(1, cfg.vocab_size, (PAR_B, PAR_PROMPT),
                            generator=g, device=dev)
    long = torch.randint(1, cfg.vocab_size, (PAR_B, PAR_LONG), generator=g,
                         device=dev)
    rng = np.random.default_rng(PAR_SEED)
    req_prompts = [rng.integers(1, cfg.vocab_size, PAR_REQ_PROMPT).tolist()
                   for _ in range(PAR_REQUESTS)]
    pc = PagedEngineConfig(max_batch=64, kv_dtype="int8", decode_horizon=8,
                           enable_radix=True, prefill_tokens_per_iter=2048)
    if rank == 0:
        # the single-process references on the full weights
        r0 = time.perf_counter()
        out["ref"] = greedy_tp(full, cfg, prompts, PAR_TOKENS)
        out["ref_long"] = greedy_tp(full, cfg, long, 1)
        # the witness: the same single process with one weight one bf16
        # ulp away (ln1 of layer 0, element 0): how far bf16 alone drifts
        ln1 = full["blocks"]["ln1"]
        keep = ln1[0, 0].clone()
        ln1[0, 0] = (keep.float() * (1 + 2 ** -7)).to(ln1.dtype)
        out["witness"] = {"first": greedy_tp(full, cfg, prompts, 1)["first"]}
        ln1[0, 0] = keep
        eng = PagedInferenceEngine(full, cfg, pc)
        out["ref_paged"] = paged_wave(eng, req_prompts, PAR_REQ_TOKENS)
        # the paged steps teacher-forced on the reference's tokens; and
        # the witness of them, ln1[0, 0] one ulp away again
        forced = forced_paged_logits(eng, req_prompts[:PAR_FORCED],
                                     out["ref_paged"]["tokens"][:PAR_FORCED])
        ln1[0, 0] = (keep.float() * (1 + 2 ** -7)).to(ln1.dtype)
        out["witness_paged"] = forced_paged_logits(
            eng, req_prompts[:PAR_FORCED],
            out["ref_paged"]["tokens"][:PAR_FORCED])["logits"]
        ln1[0, 0] = keep
        out["ref_forced"] = forced["logits"]
        del eng
        torch.cuda.empty_cache()
        # the gaps of every request, for the tokens rule
        out["ref_paged"]["gaps"] = forced_gaps(
            full, cfg, req_prompts, out["ref_paged"]["tokens"])
        out["ref_s"] = time.perf_counter() - r0
    local = tp_prepare_params(full, cfg, mesh)
    lcfg = tp_local_config(cfg, 2, data_axis=None, mesh=mesh)
    # the control's wqkv: a plain column shard, no permutation
    i, w = mesh.index("model"), full["blocks"]["wqkv"]
    per = w.q.shape[-1] // 2
    unpermuted = dict(local, blocks=dict(local["blocks"], wqkv=QuantizedTensor(
        w.q.narrow(-1, i * per, per).contiguous(),
        w.s.narrow(-1, i * per, per).contiguous())))
    out["shards"] = {k: tuple((v.q if isinstance(v, QuantizedTensor)
                               else v).shape)
                     for k, v in [("embed", local["embed"]),
                                  ("lm_head", local["lm_head"])]
                     + list(local["blocks"].items())}

    with kernel_probe() as probe:
        reset_launches()
        t1 = time.perf_counter()
        out["tp"] = greedy_tp(local, lcfg, prompts, PAR_TOKENS, mesh)
        out["tp_long"] = greedy_tp(local, lcfg, long, 1)
        out["tp_s"] = time.perf_counter() - t1
        launches_b = read_launches()
        with skip_wo_reduce(rank, on_rank=1):
            out["ctl_wo"] = {"first": greedy_tp(local, lcfg, prompts,
                                                1)["first"]}
        out["ctl_qkv"] = {"first": greedy_tp(unpermuted, lcfg, prompts,
                                             1)["first"]}
        del unpermuted
        out["b_s"] = time.perf_counter() - t0

        # (c) the paged engine at TP 2 in the bench_serving7b geometry
        t0 = time.perf_counter()
        eng = PagedInferenceEngine(full, cfg, pc, mesh=mesh)
        del full, local, w
        torch.cuda.empty_cache()
        reset_launches()
        clock = decode_clock(eng, mesh)
        mesh.time_collectives()
        out["paged"] = paged_wave(eng, req_prompts, PAR_REQ_TOKENS)
        out["paged"]["share"] = mesh.comm_s / out["paged"]["s"]
        mesh.time_collectives(False)
        launches_c = read_launches()
        out["paged"].update(clock)
        # the paged steps teacher-forced on the reference's tokens (rank
        # 0's, broadcast), then the control: rank 1 drops its paged wo sums
        want = torch.zeros((PAR_FORCED, PAR_REQ_TOKENS), dtype=torch.int64)
        if rank == 0:
            want = torch.tensor(out["ref_paged"]["tokens"][:PAR_FORCED])
        want = mesh.broadcast(want, "model").numpy()
        forced_prompts = req_prompts[:PAR_FORCED]
        out["tp_forced"] = forced_paged_logits(eng, forced_prompts,
                                               want)["logits"]
        for site in skip_paged_wo_reduce.FNS:
            with skip_paged_wo_reduce(rank, on_rank=1, site=site):
                out[f"ctl_paged_{site}"] = forced_paged_logits(
                    eng, forced_prompts, want, steps=2)["logits"]
        del eng
        torch.cuda.empty_cache()
        out["c_s"] = time.perf_counter() - t0
    # (g) each kernel of (b) and (c) on the path's own inputs
    t0 = time.perf_counter()
    out["probe"] = probe.check(f"phase 5f rank {rank}")
    out["kinds"] = sorted(map(str, probe.kinds()))
    del probe
    torch.cuda.empty_cache()
    out["launches"] = {k: launches_b[k] + launches_c[k] for k in launches_b}
    out["launches_b"], out["launches_c"] = launches_b, launches_c
    out["g_s"] = time.perf_counter() - t0

    out["ep"] = ep_part(rank, dev)
    out["ring"] = ring_part(rank, mesh, dev)
    return out


def ep_part(rank, dev) -> dict:
    """Part (e): moe_layer_ep over two ranks at BASELINE config 5's MoE
    widths (phase 5d's MOE_WIDTHS), INT8 stacks, on MOE_BATCH x MOE_PROMPT
    tokens, held against moe_layer on this rank's slice."""
    import torch

    from physics_llm_inference_tpu_torch.models.config import MoEConfig
    from physics_llm_inference_tpu_torch.models.moe import (init_moe_params,
                                                            moe_layer)
    from physics_llm_inference_tpu_torch.models.quant import \
        _quantize_stacked_int8
    from physics_llm_inference_tpu_torch.parallel import (make_mesh,
                                                          moe_layer_ep)

    t0 = time.perf_counter()
    mesh = make_mesh(expert=2, backend="gloo", device=dev)
    cfg = moe_cfg(1)
    moe = MoEConfig(num_experts=cfg.num_experts,
                    num_experts_per_tok=cfg.num_experts_per_tok,
                    capacity_factor=cfg.expert_capacity_factor)
    g = torch.Generator(device=dev).manual_seed(PAR_SEED + 2)
    p = init_moe_params(g, cfg, moe)
    params = {k: (v if k == "gate" else _quantize_stacked_int8(v))
              for k, v in p.items()}
    t = MOE_BATCH * MOE_PROMPT
    x = torch.randn((t, cfg.hidden_dim), generator=g, device=dev).to(
        torch.bfloat16)
    i, tl = mesh.index("expert"), t // 2
    ref, _ = moe_layer(x[i * tl:(i + 1) * tl], params, moe)
    got = moe_layer_ep(mesh, x, params, moe)
    torch.cuda.synchronize()
    mine = got[i * tl:(i + 1) * tl].float()
    err = float((mine - ref.float()).abs().max())
    rel = err / float(ref.float().abs().max())
    mesh.time_collectives()
    t1 = time.perf_counter()
    moe_layer_ep(mesh, x, params, moe)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t1) * 1e3
    share = mesh.comm_s / ms * 1e3
    mesh.time_collectives(False)
    t1 = time.perf_counter()
    moe_layer(x[i * tl:(i + 1) * tl], params, moe)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    return {"err": err, "rel": rel, "finite": bool(torch.isfinite(got).all()),
            "ms": ms, "plain_ms": plain_ms, "share": share,
            "s": time.perf_counter() - t0}


def ring_part(rank, mesh, dev) -> dict:
    """Part (f): ring attention over the two ranks, B 1, 32 q / 8 kv heads of
    128, S 8,192 in bf16; rank 0 holds the gathered output against K5
    flash_attention over the whole sequence and against its plain
    version."""
    import torch

    from physics_llm_inference_tpu_torch.kernels import flash_attention as kfa
    from physics_llm_inference_tpu_torch.parallel.ring_attention import \
        ring_attention

    t0 = time.perf_counter()
    r = RING
    g = torch.Generator(device=dev).manual_seed(PAR_SEED + 3)
    q = torch.randn((r["b"], r["hq"], r["s"], r["hd"]), generator=g,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn((r["b"], r["hkv"], r["s"], r["hd"]), generator=g,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    i, s = mesh.index("model"), r["s"] // 2
    chunk = [t[:, :, i * s:(i + 1) * s].contiguous() for t in (q, k, v)]
    torch.cuda.synchronize()
    mesh.time_collectives()
    t1 = time.perf_counter()
    mine = ring_attention(mesh, *chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    share = mesh.comm_s / wall
    mesh.time_collectives(False)
    whole = mesh.all_gather(mine, "model", dim=2)
    out = {"ms": wall * 1e3, "share": share}
    if rank == 0:
        launches = kfa.launches
        k5 = kfa.flash_attention(q, k, v, causal=True)
        plain = kfa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        out["k5_launched"] = kfa.launches - launches
        out["vs_k5"] = float((whole.float() - k5.float()).abs().max())
        out["vs_plain"] = float((whole.float() - plain.float()).abs().max())
        out["k5_vs_plain"] = float((k5.float() - plain.float()).abs().max())
        out["finite"] = bool(torch.isfinite(whole).all())
        del k5, plain
    del q, k, v, chunk, whole, mine
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def cli_chats(dev) -> str:
    """Part (d): `cli serve --tp 2 --dist-backend gloo --config llama7b
    --int8` launched by torch.distributed.run; PAR_CHATS greedy chat
    requests to rank 0, each answer's tokens held against the
    single-process slot engine on the same seed weights (built here first,
    then freed): identical up to the first position where the reference's
    teacher-forced top-two gap is below PAR_MARGIN. An HTTP answer carries
    no logits; the TP slot engine's steps run `forward`, which (b) holds
    by logits with its controls. The CLI's tokenizer maps a
    character to its code point mod 256, one character a token: a
    response's characters are compared position by position."""
    import argparse
    import json as _json
    import re
    import socket
    import threading
    import urllib.request

    import torch

    from physics_llm_inference_tpu_torch import cli
    from physics_llm_inference_tpu_torch.serve.api_types import \
        ChatCompletionRequest
    from physics_llm_inference_tpu_torch.serve.engine import (EngineConfig,
                                                              InferenceEngine)
    from physics_llm_inference_tpu_torch.serve.lifecycle import \
        GenerationRequest
    from physics_llm_inference_tpu_torch.serve.tokenizer_pool import \
        TokenizerPool

    t0 = time.perf_counter()
    rng = __import__("numpy").random.default_rng(PAR_SEED + 4)
    bodies = [{"model": "llama7b", "temperature": 0.0,
               "max_tokens": PAR_REQ_TOKENS,
               "messages": [{"role": "user", "content": "".join(
                   chr(int(c)) for c in rng.integers(97, 123, 40 + 8 * j))}]}
              for j in range(PAR_CHATS)]
    tok = TokenizerPool(num_workers=1)
    prompts = [tok.tokenize(ChatCompletionRequest.from_dict(b).prompt_text())
               for b in bodies]
    # the reference: the CLI's model and engine on one process
    args = argparse.Namespace(config="llama7b", hf=None, ckpt=None,
                              int8=True, device="cuda")
    params, cfg = cli._load_model(args, dev)
    eng = InferenceEngine(params, cfg, EngineConfig(num_slots=8,
                                                    max_seq_len=1024))
    rids = [eng.submit_request(GenerationRequest(
        prompt_tokens=p, max_tokens=PAR_REQ_TOKENS, temperature=0.0))
        for p in prompts]
    eng.run_until_done(rids)
    ref = [list(eng.get_result(r).tokens) for r in rids]
    gaps = forced_gaps(params, cfg, prompts, ref)
    del eng, params
    release()
    ref_s = time.perf_counter() - t0

    free, total = torch.cuda.mem_get_info()
    log(f"phase 5f (d): the card before the CLI's world: {free / 2**30:.1f} "
        f"of {total / 2**30:.1f} GiB free, this process holds "
        f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB reserved")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        master = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           "2", "--master-addr", "127.0.0.1", "--master-port", str(master),
           "-m", f"{PKG}.cli", "serve", "--tp", "2", "--dist-backend",
           "gloo", "--config", "llama7b", "--int8", "--port", "0",
           "--slots", "8", "--max-seq-len", "1024"]
    t1 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines, port = [], []
    ready = threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line.rstrip())
            if "[cli] serving on http://" in line:
                port.append(int(line.rsplit(":", 1)[1]))
                ready.set()
        ready.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        if not ready.wait(600) or not port:
            raise AssertionError("phase 5f (d): the CLI did not serve: "
                                 + " | ".join(lines[-80:]))
        up_s = time.perf_counter() - t1
        answers = []
        t2 = time.perf_counter()
        for b in bodies:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port[0]}/v1/chat/completions",
                data=_json.dumps(b).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                answers.append(_json.loads(r.read())["choices"][0]
                               ["message"]["content"])
        chat_s = time.perf_counter() - t2
    finally:
        proc.terminate()
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
        reader.join(10)
    got = [[ord(c) for c in a] for a in answers]
    want = [[t % 256 for t in r] for r in ref]
    # the two ranks share one pipe: their lines can run into each other
    ranks = sorted(set(re.findall(r"\[cli\] rank (\d): mesh", "\n".join(
        lines))))
    if ranks != ["0", "1"]:
        raise AssertionError(f"phase 5f (d): not two ranks: {ranks}")
    rule = engine_rule(want, gaps, got, "phase 5f (d) cli serve --tp 2")
    return (f"{rule}; reference {ref_s:.1f} s, the world up in {up_s:.1f} s, "
            f"{PAR_CHATS} chats one after another in {chat_s:.1f} s "
            f"({chat_s / (PAR_CHATS * PAR_REQ_TOKENS) * 1e3:.0f} ms a token "
            f"at the client, prefill included); total "
            f"{time.perf_counter() - t0:.1f} s; ranks {ranks}")


def parallel_runs(dev) -> dict:
    """Phase 5f: the parallel layer on torch.distributed at 7B widths, two
    ranks sharing the one card over gloo (tensors through host memory), a
    shared-card correctness run that measures no scaling. (a) nccl in a
    world of one; (b) TP 2 of bench.py's 7B GQA model (prefill 128 and 32
    greedy tokens, prefill 512) against the single-process per-op run on
    the same weights, and two controls; (c) the paged engine at TP 2 on 16
    requests, 8 of them teacher-forced through its steps by logits, and two
    controls; (d) `cli serve --tp 2` under torch.distributed.run; (e) EP 2
    at config 5's MoE widths; (f) ring attention at S 8,192; (g) each
    kernel of (b) and (c) against its plain version on the ranks' inputs.
    Returns the launches of (b) and (c)'s timed runs, summed over the
    ranks."""
    import numpy as np

    import torch

    t0 = time.perf_counter()
    smi = nvidia_smi()
    free, total = torch.cuda.mem_get_info()
    log(f"phase 5f: the card at the start: {free / 2**30:.1f} of "
        f"{total / 2**30:.1f} GiB free, this process holds "
        f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB reserved")
    a = spawn_ranks("nccl_world", 1, "nccl")[0]
    log(f"phase 5f (a) nccl, world 1 ({smi}): every collective the identity "
        f"on {a['device']}, transport {a['transport']}, {a['s']:.1f} s")

    r0, r1 = spawn_ranks("tp_world", 2, "gloo")
    log(f"phase 5f: shared-card correctness run, 2 ranks over gloo on one "
        f"card ({smi}); no number here is a scaling result")
    for r in (r0, r1):
        log(f"phase 5f rank {r['rank']}: transport {r['transport']}; "
            f"weights digest {r['digest']}; nccl refused: "
            f"{r['nccl_refusal']}; shards {r['shards']}")
    if r0["digest"] != r1["digest"]:
        raise AssertionError("phase 5f (b): the ranks' weights differ")
    # (b)
    for r in (r0, r1):
        log(tp_rule(r0["ref"], r["tp"], f"phase 5f (b) rank {r['rank']} "
                    f"prompt {PAR_PROMPT}"))
        log(tp_rule(r0["ref_long"], r["tp_long"], f"phase 5f (b) rank "
                    f"{r['rank']} prompt {PAR_LONG}"))
    if not (np.array_equal(r0["tp"]["tokens"], r1["tp"]["tokens"])
            and np.array_equal(r0["tp"]["first"], r1["tp"]["first"])):
        raise AssertionError("phase 5f (b): the ranks' outputs differ")
    ref_first = r0["ref"]["first"]
    scale = float(np.abs(ref_first).max())
    wit = float(np.abs(r0["witness"]["first"] - ref_first).max()) / scale
    moved = {k: int((v["first"].argmax(-1) != ref_first.argmax(-1)).sum())
             for k, v in (("TP", r0["tp"]), ("witness", r0["witness"]))}
    log(f"phase 5f (b) the bf16 witness (the single process with ln1[0, 0] "
        f"one ulp away): first-step logits off by {wit:.4g} of the largest "
        f"({scale:.4g}); first tokens moved in {moved['witness']} of "
        f"{PAR_B} rows, TP's in {moved['TP']}; the reference's top-two gaps "
        f"at its {PAR_TOKENS} positions: median "
        f"{float(np.median(r0['ref']['gaps'])):.4g}, "
        f"{float((r0['ref']['gaps'] < PAR_MARGIN).mean()):.0%} below "
        f"{PAR_MARGIN}")
    log(rule_breaks(tp_rule, r0["ref"], r0["ctl_wo"], "control: rank 1 "
                    "skips its wo all-reduce"))
    log(rule_breaks(tp_rule, r0["ref"], r0["ctl_qkv"], "control: wqkv "
                    "sharded without the column permutation"))
    log(f"phase 5f (b) decode ms a step: single process "
        f"{r0['ref']['ms']:.2f}; TP rank 0 {r0['tp']['ms']:.2f} "
        f"(collectives {r0['tp']['share']:.0%}), rank 1 "
        f"{r1['tp']['ms']:.2f} (collectives {r1['tp']['share']:.0%}); "
        f"references {r0['ref_s']:.1f} s, TP runs {r0['tp_s']:.1f} s, "
        f"part {r0['b_s']:.1f} s")
    # (c)
    ref = r0["ref_paged"]
    for r in (r0, r1):
        p = r["paged"]
        if p["trace"] != ref["trace"]:
            raise AssertionError(f"phase 5f (c) rank {r['rank']}: "
                                 f"dispatch_trace differs from the "
                                 f"reference's")
        log(engine_rule(ref["tokens"], ref["gaps"], p["tokens"],
                        f"phase 5f (c) paged TP 2 rank {r['rank']}"))
    if r0["paged"]["tokens"] != r1["paged"]["tokens"]:
        raise AssertionError("phase 5f (c): the ranks' tokens differ")
    forced = r0["ref_forced"]
    for r in (r0, r1):
        log(logits_rule(forced, r["tp_forced"], f"phase 5f (c) paged TP 2 "
                        f"rank {r['rank']}, teacher-forced"))
    wit = position_rel(forced, r0["witness_paged"])
    log(f"phase 5f (c) the bf16 witness, teacher-forced (the single process "
        f"with ln1[0, 0] one ulp away): worst {float(wit.max()):.4g}, median "
        f"{float(np.median(wit)):.4g} of the largest over the "
        f"{wit.size} positions")
    for site in ("prefill", "decode"):
        for r in (r0, r1):
            log(rule_breaks(logits_rule, forced[:, :2],
                            r[f"ctl_paged_{site}"], f"control: rank 1 drops "
                            f"its paged {site} step's wo sums, seen on rank "
                            f"{r['rank']}"))
    ranks = "; ".join(
        f"rank {r['rank']} {r['paged']['s']:.1f} s (collectives "
        f"{r['paged']['share']:.0%}), {r['paged']['steps']} decode steps at "
        f"{r['paged']['step_ms']:.1f} ms (collectives "
        f"{r['paged']['step_share']:.0%})" for r in (r0, r1))
    log(f"phase 5f (c) {PAR_REQUESTS} requests of prompt {PAR_REQ_PROMPT}, "
        f"{PAR_REQ_TOKENS} tokens: reference {ref['s']:.1f} s; TP {ranks}; "
        f"dispatch_trace identical on both ranks and the reference's; part "
        f"{r0['c_s']:.1f} s")
    # (e), (f)
    for r in (r0, r1):
        e = r["ep"]
        if not (e["finite"] and e["rel"] <= 1e-2):
            raise AssertionError(f"phase 5f (e) rank {r['rank']}: EP off "
                                 f"moe_layer by {e['rel']:.4g} (> 1e-2)")
        log(f"phase 5f (e) EP 2 rank {r['rank']}: max abs err {e['err']:.4g} "
            f"(rel {e['rel']:.4g} <= 1e-2) against moe_layer on its slice; "
            f"wall: EP {e['ms']:.2f} ms (collectives {e['share']:.0%}), "
            f"moe_layer on the slice {e['plain_ms']:.2f} ms; part "
            f"{e['s']:.1f} s")
    f = r0["ring"]
    if not (f["finite"] and f["vs_k5"] <= 2e-2 and f["vs_plain"] <= 2e-2
            and f["k5_launched"] >= 1):
        raise AssertionError(f"phase 5f (f): ring attention {f}")
    log(f"phase 5f (f) ring attention S {RING['s']}: max abs err vs K5 "
        f"{f['vs_k5']:.4g}, vs plain {f['vs_plain']:.4g} (K5 vs plain "
        f"{f['k5_vs_plain']:.4g}; rule 2e-2); rank 0 {f['ms']:.1f} ms "
        f"(collectives {f['share']:.0%}), rank 1 {r1['ring']['ms']:.1f} ms "
        f"(collectives {r1['ring']['share']:.0%}); part {f['s']:.1f} s")
    # (g)
    need = ("int8_matmul", "int8_matmul_prefill", "int8_kv_decode_attention",
            "flash_attention", "int8_paged_decode_attention")
    for r in (r0, r1):
        missing = [k for k in need if r["launches"][k] == 0]
        if missing:
            raise AssertionError(f"phase 5f (g) rank {r['rank']}: kernels "
                                 f"not launched: {missing}")
        log(f"phase 5f (g) rank {r['rank']} launches: (b) "
            f"{ {k: v for k, v in r['launches_b'].items() if v} }, (c) "
            f"{ {k: v for k, v in r['launches_c'].items() if v} }; on the "
            f"path's inputs: {r['probe']}; {r['g_s']:.1f} s")
    log(cli_chats(dev))
    log(f"phase 5f (parallel layer): {time.perf_counter() - t0:.1f} s")
    return {k: r0["launches"][k] + r1["launches"][k] for k in KERNELS}


# Part A (--capture): captured steps held against eager runs
CAPTURE_REPS = 5          # repetitions of the stress (part 4)
INTERLEAVED_LAUNCHES = 3000  # replays (and as many eager launches) of K4, K8
# the full run's, inside its time limit: phase 5 itself ran the stress's
# checks once more
FULL_RUN_CAPTURE = dict(reps=2, interleaved=300)


def pool_order_check(dev) -> str:
    """Part A, check 1: two captured steps of one owner, A (K1 into an
    intermediate of B's output size, then a row sum) and B (K1 into its
    static output). Capture A, then B; replay B, A, B, A: after each
    replay B's static output must equal an eager B. The same with raw
    torch.cuda.graph captures sharing one pool is the control: where it
    changes B's output, a shared pool's hazard is live on this card."""
    import torch

    from physics_llm_inference_tpu_torch.kernels.int8_matmul import \
        int8_matmul
    from physics_llm_inference_tpu_torch.runtime.step_cache import \
        CapturedStep

    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    M, K, N = 64, 4096, 4096

    def w():
        return (torch.randint(-127, 128, (K, N), dtype=torch.int8,
                              generator=g, device=dev),
                torch.rand((1, N), generator=g, device=dev) * 1e-2)

    wa, wb = w(), w()
    xa = (torch.randn((M, K), generator=g, device=dev) * 0.1).bfloat16()
    xb = (torch.randn((M, K), generator=g, device=dev) * 0.1).bfloat16()

    def fa():
        return int8_matmul(xa, *wa).float().sum(dim=-1)

    def fb():
        return int8_matmul(xb, *wb)

    want = fb().clone()

    def run(make) -> list:
        a = make(fa)
        b = make(fb)
        bad = []
        for i, step in enumerate((b, a, b, a)):
            step()
            torch.cuda.synchronize()
            if not torch.equal(b.out, want):
                bad.append(i)
        return bad

    port = run(lambda fn: CapturedStep(fn, dev))

    class Raw:
        """A raw capture into the shared pool, warmed up first."""

        def __init__(self, fn):
            fn()
            torch.cuda.synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=shared):
                self.out = fn()

        def __call__(self):
            self.graph.replay()
            return self.out

    shared = torch.cuda.graph_pool_handle()
    control = run(Raw)
    line = (f"pool order (check 1): B's static output after the replays "
            f"B, A, B, A differs from an eager B after replays {port} "
            f"(the port's graphs); control, raw graphs sharing one pool: "
            f"after replays {control}"
            + (" (the shared pool's hazard is live)" if control
               else " (the control did not show the hazard)"))
    log(line)
    if port:
        raise AssertionError(line)
    return line


def _disjoint_tables(g, dev, B: int, MB: int, NB: int):
    """(B, MB) block tables, no block in two rows and none the trash block
    (NB - 1): a launch's writes then land where no row reads."""
    import torch

    return torch.randperm(NB - 1, generator=g, device=dev)[:B * MB].reshape(
        B, MB).int()


def _launch_difference(got, want) -> str:
    """Where a launch's outputs differ from the reference launch's: for
    each output that differs, its elements that differ and the largest
    difference, and for a stack (a leading layer axis, K4's written cache
    rows) the first layer that differs and its rows."""
    import torch

    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        ne = a != b
        if not bool(ne.any()):
            continue
        d = float((a.float() - b.float()).abs().max())
        s = f"output {i}: {int(ne.sum())} elements, by up to {d:.4g}"
        if a.dim() == 3:
            l = int(ne.flatten(1).any(dim=1).nonzero()[0])
            rows = ne[l].flatten(1).any(dim=1).nonzero()[:, 0].tolist()
            s += f", first at layer {l}, rows {rows[:8]}"
        elif a.dim() == 2:
            rows = ne.any(dim=1).nonzero()[:, 0].tolist()
            s += f", rows {rows[:8]} ({len(rows)})"
        out.append(s)
    return "; ".join(out)


def kernel_determinism(dev, params, cfg,
                       launches: int = INTERLEAVED_LAUNCHES,
                       forms=("replay", "eager"), only=None) -> str:
    """Part A, check 2: each kernel of phase 5's captured paths at the main
    path's shapes, captured once, then its replays interleaved with eager
    launches on the same inputs, each held bit for bit against the first
    eager launch: K4 W8A16 (32 layers, B 64, S 256, write slot 200) and K8
    (the engine's geometry, disjoint tables) `launches` times each; K4
    W8A8, K1 on each route, K2, K3, K5 (square, and the paged chunk's
    4 x 512 over 1,024) and the library GEMM of prefill-sized linears
    (M 2,048 and 4,096; its handle's workspace is the capture stream's
    under capture) a tenth as often, at least 20 times. `forms` picks the
    launches (replays, eager ones, or both in turn) and `only` the cases
    by name (`--determinism`)."""
    import dataclasses

    import torch

    from physics_llm_inference_tpu_torch.kernels import fused_decode as kf
    from physics_llm_inference_tpu_torch.kernels.flash_attention import \
        flash_attention
    from physics_llm_inference_tpu_torch.kernels.int8_kv_attention import \
        int8_kv_decode_attention
    from physics_llm_inference_tpu_torch.kernels.int8_matmul import _launch
    from physics_llm_inference_tpu_torch.kernels.lmhead import lmhead_greedy
    from physics_llm_inference_tpu_torch.models.transformer import \
        _linear_f32
    from physics_llm_inference_tpu_torch.ops.rope import rope_frequencies
    from physics_llm_inference_tpu_torch.runtime.step_cache import \
        CapturedStep

    g = torch.Generator(device=dev).manual_seed(SEED + 33)
    blocks, lm = params["blocks"], params["lm_head"]
    L, B, S = cfg.num_layers, 64, 256
    D, hq, hkv, hd = cfg.hidden_dim, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim

    def act(*shape):
        return (torch.randn(shape, generator=g, device=dev)
                * shape[-1] ** -0.5).bfloat16()

    cos, sin = rope_frequencies(hd, cfg.max_seq_len, device=dev)
    x = act(B, D)
    cache = []
    for _ in ("k", "v"):
        cache += [torch.randint(-127, 128, (L, B, S, hkv * hd),
                                dtype=torch.int8, generator=g, device=dev),
                  torch.rand((L, B, hkv, S), generator=g, device=dev) * 0.03]
    slot = torch.full((B,), 200, dtype=torch.int32, device=dev)
    vfrom = torch.zeros(B, dtype=torch.int32, device=dev)
    c200, s200 = cos[200].expand(B, -1), sin[200].expand(B, -1)

    def k4(c):
        def run():
            x_out, kq_, ks_, vq_, vs_ = kf.fused_decode_step(
                blocks, x, *cache, slot, vfrom, c200, s200, c, slot=slot,
                write_cache=True)
            return [x_out, kq_[:, :, 200], ks_[..., 200], vq_[:, :, 200],
                    vs_[..., 200]]
        return run

    NB, BS, MB = 161, 512, 2
    kvp = torch.randint(-127, 128, (L, NB, 2, BS, hkv * hd),
                        dtype=torch.int8, generator=g, device=dev)
    kvs = torch.rand((L, NB, 2, hkv, BS), generator=g, device=dev) * 0.03
    tables = _disjoint_tables(g, dev, B, MB, NB)
    plens = torch.randint(1, MB * BS - 1, (B,), generator=g,
                          device=dev).int()
    pos = plens.long()
    wgu = blocks["w_gate_up"]
    w0 = type(wgu)(wgu.q[0], wgu.s[0])
    xs = {m: act(m, D) for m in (64, 512, 2048, 4096)}
    q2 = act(B, hq, hd)
    last = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    q5, k5 = act(8, hq, 512, hd), act(8, hkv, 512, hd)
    qc, kc = act(4, hq, 512, hd), act(4, hkv, 1024, hd)
    off = torch.tensor([0, 100, 512, 511], device=dev)
    few = max(20, launches // 10)
    cases = [
        ("K4 W8A16", k4(cfg), launches),
        ("K8", lambda: [kf.fused_paged_decode_step(
            blocks, x, kvp, kvs, tables, plens, cos[pos], sin[pos], cfg,
            inplace=True)[0]], launches),
        ("K4 W8A8", k4(dataclasses.replace(cfg, act_quant="int8")), few),
        ("K1 stream, M 64", lambda: [_launch("stream", xs[64], w0.q,
                                             w0.s)], few),
        ("K1 wgmma, M 512", lambda: [_launch("wgmma", xs[512], w0.q,
                                             w0.s)], few),
        ("K2, B 64, S 256", lambda: [int8_kv_decode_attention(
            q2, cache[0][0], cache[1][0], cache[2][0], cache[3][0], last)],
         few),
        ("K3, B 64", lambda: [lmhead_greedy(xs[64], params["norm"], lm.q,
                                            lm.s, eps=cfg.norm_eps)], few),
        ("K5, B 8, S 512", lambda: [flash_attention(q5, k5, k5,
                                                    causal=True)], few),
        ("K5, paged chunk (4 x 512 over 1,024)", lambda: [flash_attention(
            qc, kc, kc, q_offset=off, causal=True)], few)] + [
        (f"torch.mm f32 out, M {m}", lambda m=m: [_linear_f32(xs[m], w0)],
         few) for m in (2048, 4096)]
    res, failed = [], False
    for name, fn, n in cases:
        if only is not None and name not in only:
            continue
        want = [t.clone() for t in fn()]
        captured = CapturedStep(lambda fn=fn: fn(), dev)
        bad = {"replay": [], "eager": []}
        first = ""
        for i in range(n):
            for kind, run in (("replay", captured), ("eager", fn)):
                if kind not in forms:
                    continue
                got = run()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    bad[kind].append(i)
                    first = first or (f" (the first, {kind} {i}: "
                                      f"{_launch_difference(got, want)})")
        torch.cuda.synchronize()
        failed = failed or bool(bad["replay"] or bad["eager"])
        res.append(f"{name}: " + " and ".join(
            f"{len(bad[k])} of {n} {k} launches" for k in forms)
            + f" differ{first}")
        del captured
    line = ("kernels captured and eager, interleaved on fixed inputs "
            "(check 2): " + "; ".join(res))
    log(line)
    if failed:
        raise AssertionError(line)
    return line


def decode_lockstep(dev, params, cfg, prompt: int) -> str:
    """Part A, check 3 (dense): cached_generate's loop captured (through a
    step cache, as phase 5 runs it) and the same loop stepped eagerly, in
    lockstep on full_run's prompts: the two prefills (logits and written
    caches), then after each decode step the current tokens and the cache
    slot the step wrote (codes and scales, every layer). Reports the first
    step that differs and what."""
    import torch

    from physics_llm_inference_tpu_torch.ops.sampling import sample_token
    from physics_llm_inference_tpu_torch.runtime import generate as gen

    g = torch.Generator().manual_seed(SEED + prompt)
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, prompt),
                            generator=g).tolist()
    ids, lens = gen.pad_and_stack(prompts, device=dev)
    b, p = ids.shape
    cap = -(-(p + NEW_TOKENS) // 128) * 128
    steps = gen.decode_step_cache()
    key = (gen._Same(params), cfg, b, cap, torch.int8, True, 0, False, (),
           0, None)
    loop_c, step_c = steps.get(*key)
    loop_e = gen.DecodeLoop(params, cfg, b, cap, torch.int8, True, 0, False,
                            (), 0, None)
    firsts = []
    for loop in (loop_c, loop_e):
        logits, _, vfrom = gen._prefill(params, cfg, ids, lens,
                                        loop.cache.as_slice())
        firsts.append((logits, vfrom))
    torch.cuda.synchronize()
    found = []
    if not torch.equal(firsts[0][0], firsts[1][0]):
        found.append("prefill logits")
    for name in ("k", "v"):
        a, e = getattr(loop_c.cache, name), getattr(loop_e.cache, name)
        if not (torch.equal(a.q[:, :, :p], e.q[:, :, :p])
                and torch.equal(a.s[..., :p], e.s[..., :p])):
            found.append(f"prefill {name} cache")
    for loop, (logits, vfrom) in zip((loop_c, loop_e), firsts):
        loop.begin(sample_token(logits, None, temperature=0.0), lens, vfrom,
                   p, 0.0, 1.0)
    first_step = None
    for i in range(NEW_TOKENS):
        step_c()
        loop_e.step()
        what = []
        if not torch.equal(loop_c.tok, loop_e.tok):
            what.append(f"tokens of {int((loop_c.tok != loop_e.tok).sum())}"
                        " rows")
        at = p + i
        for name in ("k", "v"):
            a, e = getattr(loop_c.cache, name), getattr(loop_e.cache, name)
            if not (torch.equal(a.q[:, :, at], e.q[:, :, at])
                    and torch.equal(a.s[..., at], e.s[..., at])):
                what.append(f"{name} cache slot {at}")
        if what and first_step is None:
            first_step = (i, what)
    same = torch.equal(loop_c.emitted, loop_e.emitted)
    line = (f"decode lockstep (check 3), prompt {prompt}: prefill "
            + (f"differs ({', '.join(found)})" if found else "identical")
            + "; decode "
            + (f"first differs at step {first_step[0]} "
               f"({', '.join(first_step[1])})" if first_step
               else f"identical over {NEW_TOKENS} steps")
            + f"; emitted tokens identical: {same}")
    log(line)
    if found or first_step or not same:
        raise AssertionError(line)
    return line


def _owned_positions(eng):
    """(blocks + trash, block size) bool on the engine's device: every
    position of every block but the trash block, which the rows that do not
    decode in a dispatch write (which of those writes lands is
    unspecified). A decode dispatch writes through the tables of its
    decoding rows only, so every other position two engines hold on one
    request stream must agree."""
    import torch

    c = eng.config
    owned = torch.ones((c.num_blocks + 1, c.block_size), dtype=torch.bool,
                       device=eng.device)
    owned[eng._trash] = False
    return owned


def _differing_positions(a, b, live):
    """(layers, blocks, 2, block size) bool: the positions (`live`) where
    two INT8 pools' codes or scales differ, a layer at a time (a whole pool
    compared at once is tens of GiB)."""
    import torch

    return torch.stack([
        ((a.q[l] != b.q[l]).any(dim=-1) | (a.s[l] != b.s[l]).any(dim=2))
        & live[:, None, :] for l in range(a.q.shape[0])])


def _pool_difference(eng, a, b, diff) -> str:
    """Where two INT8 pools differ (`diff`, _differing_positions): layers, K or V pages, the largest code and
    scale differences, and for each of the first blocks its positions and
    whose it is in `eng`."""
    import torch

    hit = diff.nonzero()
    blocks = sorted(set(hit[:, 1].tolist()))
    code = max(int((a.q[l].int() - b.q[l].int()).abs().max())
               for l in sorted(set(hit[:, 0].tolist())))
    owners = {}
    for rid, t in eng.pool.tables.items():
        for i, blk in enumerate(t.block_ids):
            owners.setdefault(blk, []).append(
                f"{rid}[{i}] (tokens {t.num_tokens})")
    radix = getattr(eng, "_radix_owned", {})
    parts = []
    for blk in blocks[:6]:
        pos = sorted(set(diff[:, blk].nonzero()[:, 2].tolist()))
        who = owners.get(blk) or (["radix"] if blk in radix else ["?"])
        parts.append(f"block {blk} positions {pos[:4]}..{pos[-4:]} "
                     f"({len(pos)}) of {', '.join(who)}")
    return (f"{len(blocks)} blocks differ, layers "
            f"{sorted(set(hit[:, 0].tolist()))[:6]}, pages "
            f"{sorted(set(hit[:, 2].tolist()))}, codes by up to {code}: "
            + "; ".join(parts))


def paged_lockstep(dev, params, cfg) -> str:
    """Part A, check 3 (paged): the paged engine in the bench_serving7b
    configuration, captured, and the same engine with eager dispatch
    functions (eager_engine_class), each warmed up, on one request stream
    (a warm wave of 64 x 16 tokens, then 128 requests of prompt 576, every
    fourth behind a shared block, 64 greedy tokens), stepped in turn: after
    each engine step the emitted tokens, the dispatches it made and both
    pools whole but for the trash block (_owned_positions). Reports the
    first step that differs."""
    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.serve.engine import GenerationRequest
    from physics_llm_inference_tpu_torch.serve.paged_engine import (
        PagedEngineConfig, PagedInferenceEngine)

    pc = PagedEngineConfig(max_batch=64, kv_dtype="int8", decode_horizon=8,
                           enable_radix=True, prefill_tokens_per_iter=2048)
    engs = [PagedInferenceEngine(params, cfg, pc),
            eager_engine_class()(params, cfg, pc)]
    for eng in engs:
        eng.warmup()
        eng.dispatch_trace = []
    rng = np.random.default_rng(SEED)
    prefixes = [rng.integers(1, cfg.vocab_size, pc.block_size).tolist()
                for _ in range(SHARED_PREFIXES)]

    def submit(eng, count, tokens, seed):
        rng = np.random.default_rng(seed)
        for i in range(count):
            pre = prefixes[(i // 4) % SHARED_PREFIXES] if i % 4 == 0 else []
            p = pre + rng.integers(1, cfg.vocab_size,
                                   SERVE_PROMPT - len(pre)).tolist()
            eng.submit_request(GenerationRequest(
                prompt_tokens=p, max_tokens=tokens, temperature=0.0))

    first, n_steps = None, 0
    for count, tokens, seed in ((64, 16, SEED + 1),
                                (SERVE_REQUESTS, SERVE_TOKENS, SEED + 2)):
        for eng in engs:
            submit(eng, count, tokens, seed)
        while any(e.scheduler.waiting or e.scheduler.running for e in engs):
            outs, marks = [], []
            for eng in engs:
                mark = len(eng.dispatch_trace)
                outs.append(eng.step())
                marks.append(eng.dispatch_trace[mark:])
            torch.cuda.synchronize()
            n_steps += 1
            what = []
            if outs[0] != outs[1]:
                what.append("emitted tokens")
            if marks[0] != marks[1]:
                what.append(f"dispatches {marks[0]} against {marks[1]}")
            diff = _differing_positions(engs[0]._k, engs[1]._k,
                                        _owned_positions(engs[0]))
            if bool(diff.any()):
                what.append("pool blocks" if first else
                            "pool blocks: " + _pool_difference(
                                engs[0], engs[0]._k, engs[1]._k, diff)
                            + f"; this step's dispatches {marks[0]}")
            if what and first is None:
                first = (n_steps, what)
            if n_steps > 20000:
                raise AssertionError("paged lockstep: the engines did not "
                                     "drain")
    line = ("paged engine lockstep (check 3), bench_serving7b "
            f"configuration, {n_steps} engine steps, "
            f"{len(engs[0].dispatch_trace)} dispatches: "
            + (f"first differs at step {first[0]} ({'; '.join(first[1])})"
               if first else "captured and eager identical at every step "
               "(tokens, dispatches, every pool block but the trash block)"))
    log(line)
    del engs
    release()
    if first:
        raise AssertionError(line)
    return line


def capture_stress(dev, params, cfg, reps: int = CAPTURE_REPS) -> str:
    """Part A, check 4: phase 5's captured-against-eager checks run `reps`
    times in this process: full_run at prompt 128 and 512 (fused W8A16),
    each followed by check 3's step-by-step lockstep of the same loop, and
    the paged engine's captured waves against its eager ones (one wave
    each time). Every failure is logged; the part fails after the last
    repetition if any did."""
    fused = ("int8_matmul", "fused_decode_step", "lmhead_greedy")
    fails, t0 = [], time.perf_counter()
    for rep in range(reps):
        for prompt, expect in ((PROMPT, fused),
                               (LONG_PROMPT, fused + ("flash_attention",))):
            for what, run in (
                    ("full_run", lambda: full_run(
                        dev, params, prompt, True, cfg.num_layers, expect)),
                    ("lockstep", lambda: decode_lockstep(dev, params, cfg,
                                                         prompt))):
                try:
                    run()
                except AssertionError as e:
                    fails.append(f"rep {rep}, prompt {prompt}, {what}: {e}")
                    log(f"capture stress: {fails[-1]}")
        try:
            serve(dev, params, serving_cfg(), "capture stress, paged "
                  "engine", dict(max_batch=64, kv_dtype="int8",
                                 decode_horizon=8, enable_radix=True,
                                 prefill_tokens_per_iter=2048),
                  SERVE_REQUESTS, SERVE_PROMPT, SERVE_TOKENS,
                  expect=("fused_paged_decode_step", "flash_attention",
                          "int8_matmul"), forbid=(), shared=True, warm=64,
                  waves=1, compare=True)
        except AssertionError as e:
            fails.append(f"rep {rep}, paged wave: {e}")
            log(f"capture stress: {fails[-1]}")
        release()
    line = (f"capture stress (check 4): {reps} repetitions of full_run and "
            f"the decode lockstep at prompt {PROMPT} and {LONG_PROMPT} (fused "
            f"W8A16) and of the paged engine's captured wave against its "
            f"eager one: {len(fails)} of {5 * reps} failed "
            f"({time.perf_counter() - t0:.1f} s)")
    log(line)
    if fails:
        raise AssertionError(line + ": " + " | ".join(fails))
    return line


def determinism_alone(dev, form: str, n: int) -> str:
    """`--determinism FORM N`: part A's check 2 on K4 W8A16 alone (32
    layers, B 64, S 256, its fixed inputs), N launches replayed, eager, or
    both in turn (FORM replay, eager or interleave), each held bit for bit
    against the first eager launch. A race as rare as once in 4,000
    launches needs ~10,000 of each form to show."""
    import torch

    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import init_params_int8

    forms = {"replay": ("replay",), "eager": ("eager",),
             "interleave": ("replay", "eager")}[form]
    cfg = ModelConfig(num_layers=32, **WIDTHS)
    params = init_params_int8(
        torch.Generator(device=dev).manual_seed(SEED), cfg)
    return kernel_determinism(dev, params, cfg, n, forms=forms,
                              only=("K4 W8A16",))


def capture_runs(dev, params=None, reps: int = CAPTURE_REPS,
                 interleaved: int = INTERLEAVED_LAUNCHES) -> None:
    """Part A (--capture): checks 1-4 on the bench.py 7B model at 32 layers
    (`params`: phase 5's INT8 weights, or made here from phase 5's seed),
    the stress `reps` times, check 2's interleaving `interleaved` launches
    of each form. Every check runs and logs before the first failure
    raises."""
    import torch

    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.quant import init_params_int8

    cfg = ModelConfig(num_layers=32, **WIDTHS)
    if params is None:
        params = init_params_int8(
            torch.Generator(device=dev).manual_seed(SEED), cfg)
    t0 = time.perf_counter()
    errors = []
    checks = [lambda: pool_order_check(dev),
              lambda: kernel_determinism(dev, params, cfg, interleaved),
              lambda: decode_lockstep(dev, params, cfg, PROMPT),
              lambda: decode_lockstep(dev, params, cfg, LONG_PROMPT),
              lambda: paged_lockstep(dev, params, serving_cfg()),
              lambda: capture_stress(dev, params, cfg, reps)]
    for check in checks:
        try:
            check()
        except AssertionError as e:
            errors.append(str(e))
        release()
    log(f"part A (--capture): {len(checks) - len(errors)} of {len(checks)} "
        f"checks passed, {time.perf_counter() - t0:.1f} s")
    if errors:
        raise AssertionError("part A: " + " || ".join(errors))


# phase 5g (--train): a checkpoint trained on the card, and what it measures
TRAIN_LOSS_MARGIN = 1.0      # nats the last 25 logged losses' mean must fall
TRAIN_PROBED_CALL = 128      # the W8A8 decode-path call whose inputs are held
SPEC_K, SPEC_SLOTS, SPEC_PROMPT, SPEC_DECODE = 4, 8, 128, 64


def trained_w8a8(dev, ckpt: str, counts: dict) -> str:
    """Phase 5g (c): W8A8's decode-path perplexity on the trained weights
    (INT8 stacks, act_quant int8, INT8 cache: phase 5e's route), one K4
    W8A8 launch a one-token forward; its TRAIN_PROBED_CALL-th launch's
    inputs held to W8A8's rule two layers at a time (w8a8_windows), each
    window also reporting which of phase 3's controls (a quantization point
    left out) it catches: the rule's power on trained weights."""
    import dataclasses

    import torch

    from physics_llm_inference_tpu_torch.bench.perplexity import \
        decode_path_perplexity
    from physics_llm_inference_tpu_torch.models.quant import \
        quantize_params_int8

    params, cfg, held = trained_model(dev, ckpt)
    cfg8 = dataclasses.replace(cfg, act_quant="int8")
    q8 = quantize_params_int8(params)
    reset_launches()
    with kernel_probe(("fused_decode_step",),
                      at={"fused_decode_step": TRAIN_PROBED_CALL}) as probe:
        ppl = decode_path_perplexity(q8, cfg8, held, window=256,
                                     kv_dtype=torch.int8)
    c = read_launches()
    for k in KERNELS:
        counts[k] += c[k]
    steps = 256 - 1
    if c["fused_decode_step_w8a8"] != steps:
        raise AssertionError(f"phase 5g: W8A8 decode path launched K4 W8A8 "
                             f"{c['fused_decode_step_w8a8']} times, not "
                             f"{steps}")
    (key, (a, kw)), = probe.calls.items()
    kf = kernel_module("fused_decode_step")
    qslot, vfrom, cos, sin, c8 = a[6:]
    if vfrom is None:
        vfrom = torch.zeros_like(qslot, dtype=torch.int32)
    rule = w8a8_windows(kf, a[0], a[1], a[2:6], (qslot, vfrom, cos, sin, c8),
                        kw, "phase 5g: K4 W8A8, trained weights",
                        require_controls=False)
    return (f"W8A8 decode path (INT8 cache) perplexity {ppl:.4f}, K4 W8A8 "
            f"{steps} launches; its call {TRAIN_PROBED_CALL} held two layers "
            f"at a time: {rule}")


def trained_model(dev, ckpt: str):
    """(bf16 params on the card, bf16 ModelConfig, held-out tokens of
    bench/accuracy's 32 windows of 256) of a bench/train_toy checkpoint."""
    import dataclasses

    import numpy as np
    import torch

    from physics_llm_inference_tpu_torch.models.config import ModelConfig
    from physics_llm_inference_tpu_torch.models.loader import load_params

    conf = json.loads((Path(ckpt) / "config.json").read_text())
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(dtype="bfloat16", **{k: v for k, v in conf.items()
                                           if k in fields})
    params = load_params(str(Path(ckpt) / "params.npz"), device=dev)

    def cast(t):
        return {k: cast(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.to(torch.bfloat16)

    held = np.load(Path(ckpt) / "heldout.npy")
    return cast(params), cfg, held[:32 * 256]


def trained_speculation(dev, ckpt: str, counts: dict) -> str:
    """Phase 5g (d): the slot engine on the trained INT8 weights with
    speculative_k = SPEC_K against 0 (bench/speculative.run_case), on
    SPEC_SLOTS prompts of SPEC_PROMPT held-out tokens, SPEC_DECODE greedy
    tokens: accepted tokens a dispatch, each wall, and the tokens held to
    the plain engine's up to near-ties (spec_ties)."""
    import numpy as np

    from physics_llm_inference_tpu_torch.bench.speculative import run_case
    from physics_llm_inference_tpu_torch.models.quant import \
        quantize_params_int8

    params, cfg, _ = trained_model(dev, ckpt)
    held = np.load(Path(ckpt) / "heldout.npy")
    step = (len(held) - SPEC_PROMPT) // SPEC_SLOTS
    prompts = [held[i * step:i * step + SPEC_PROMPT].tolist()
               for i in range(SPEC_SLOTS)]
    q8 = quantize_params_int8(params)
    reset_launches()
    rows = [run_case(q8, cfg, k, prompts, SPEC_DECODE, "trained, held-out")
            for k in (0, SPEC_K)]
    c = read_launches()
    for k in KERNELS:
        counts[k] += c[k]
    plain, spec = rows
    ties = spec_ties(q8, cfg, prompts, plain["outputs"], spec["outputs"],
                     f"speculative_k={SPEC_K} against 0")
    return (f"speculative_k={SPEC_K} on {SPEC_SLOTS} held-out prompts of "
            f"{SPEC_PROMPT} tokens, {SPEC_DECODE} greedy tokens: "
            f"{spec['tokens_per_dispatch']:.3f} tokens accepted a dispatch "
            f"over {spec['dispatches']} dispatches, wall "
            f"{spec['wall_s']:.4f} s ({spec['tok_per_s']:.1f} tok/s) against "
            f"speculative_k=0's {plain['wall_s']:.4f} s "
            f"({plain['tok_per_s']:.1f} tok/s); {ties}")


def train_runs(dev) -> dict:
    """Phase 5g (--train): (a) bench/train_toy trains 14m for 600 steps on
    the card in a temporary directory (bytes where `tokenizers` is absent);
    the mean of its last 25 logged losses must sit TRAIN_LOSS_MARGIN below
    the first; (b) bench/accuracy.main(["--ckpt", dir]) on it, whose INT8
    budget stands as the script's assertions do, K4 launched in W8A16 and
    W4A16; (c) trained_w8a8; (d) trained_speculation. Returns the launches
    of (b)-(d)."""
    import tempfile

    from physics_llm_inference_tpu_torch.bench import accuracy, train_toy

    counts = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory(prefix="toy-") as tmp:
        t0 = time.perf_counter()
        res = train_toy.main(["--out", tmp])
        losses = [v for _, v in res["losses"]]
        last = losses[-25:]
        mean = sum(last) / len(last)
        log(f"phase 5g (a) bench/train_toy, {res['size']} "
            f"({res['params'] / 1e6:.2f} M params, {res['tokenizer']} "
            f"tokenizer, vocab {res['vocab_size']}, {res['tokens']} tokens, "
            f"{res['heldout_tokens']} held out), {res['steps']} steps in "
            f"{res['train_s']:.1f} s ({nvidia_smi()}): loss "
            f"{losses[0]:.4f} first, {losses[-1]:.4f} last, the last "
            f"{len(last)} logged losses' mean {mean:.4f} (margin "
            f"{TRAIN_LOSS_MARGIN} below the first: "
            f"{mean < losses[0] - TRAIN_LOSS_MARGIN}); "
            f"{time.perf_counter() - t0:.1f} s with the corpus")
        if not mean < losses[0] - TRAIN_LOSS_MARGIN:
            raise AssertionError("phase 5g: the loss did not fall: "
                                 f"{res['losses']}")
        reset_launches()
        t0 = time.perf_counter()
        acc = accuracy.main(["--ckpt", tmp])
        c = read_launches()
        for k in KERNELS:
            counts[k] += c[k]
        dec = acc["decode"]
        log(f"phase 5g (b) bench/accuracy on the trained checkpoint "
            f"({nvidia_smi()}; {time.perf_counter() - t0:.1f} s): parallel "
            f"forward bf16 {acc['forward']['ppl_fp']:.4f}, INT8 W "
            f"{acc['forward']['ppl_quantized']:.4f} "
            f"({acc['forward']['delta']:+.4f}); decode path bf16 "
            f"{acc['decode_fp']:.4f}, INT8 W+KV {dec['int8']['ppl']:.4f} "
            f"({dec['int8']['delta']:+.4f}), INT4 RTN "
            f"{dec['int4']['ppl']:.4f} ({dec['int4']['delta']:+.4f}), INT4 "
            f"MSE {dec['int4_mse']['ppl']:.4f} "
            f"({dec['int4_mse']['delta']:+.4f}); budget "
            f"{acc['budget']:.4f}, within: {acc['within_budget']}; K4 "
            f"launches W8A16 {c['fused_decode_step']}, W4A16 "
            f"{c['fused_decode_step_w4a16']}")
        if not acc["within_budget"]:
            raise AssertionError("phase 5g: the INT8 deltas break "
                                 f"bench/accuracy's budget: {acc}")
        if not (c["fused_decode_step"] and c["fused_decode_step_w4a16"]):
            raise AssertionError(f"phase 5g: K4 did not run: {c}")
        log(f"phase 5g (c) ({nvidia_smi()}): "
            f"{trained_w8a8(dev, tmp, counts)}")
        release()
        log(f"phase 5g (d) ({nvidia_smi()}): "
            f"{trained_speculation(dev, tmp, counts)}")
    release()
    return counts


# phase 5h (--benches): the bench modules at their defaults
BENCHES = (  # module, the kernels its run must launch
    ("serving7b", ("fused_paged_decode_step", "int8_matmul",
                   "int8_matmul_prefill", "flash_attention")),
    # the slot engine: K4 decodes its horizons; the verify window (k + 1
    # queries) attends its INT8 slots by the plain dequantized product, as
    # any forward of fewer than 128 queries; the heads sample, so K1, not K3
    ("speculative", ("int8_matmul", "int8_matmul_prefill",
                     "fused_decode_step")),
    ("attribution", ("int8_matmul", "int8_kv_decode_attention")),
    ("probe_step_overhead", ("fused_decode_step", "int8_matmul",
                             "lmhead_greedy")),
    ("probe_prefill", ("int8_matmul_prefill",)),
)


def bench_check(name: str, out: dict) -> str:
    """What each bench's result must hold beyond its launches."""
    import math

    if name == "serving7b":
        want = out["config"]["requests"] * out["config"]["decode"]
        if out["num_requests"] != out["config"]["requests"] or \
                out["tokens_per_s"] * out["total_time_s"] < want - 0.5:
            raise AssertionError(f"phase 5h: serving7b served {out}")
        return (f"{out['total_time_s']:.3f} s, {out['tokens_per_s']:.1f} "
                f"tok/s, TTFT p50 {out['ttft']['p50_ms']:.1f} ms")
    if name == "speculative":
        # the module's weights and prompts, made again from its seeds, for
        # the reference forwards of spec_ties
        import numpy as np
        import torch

        from physics_llm_inference_tpu_torch.bench import speculative as sp
        from physics_llm_inference_tpu_torch.models.quant import \
            init_params_int8

        cfg = sp.model_config()
        params = init_params_int8(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        rows = out["rows"]
        ties = [spec_ties(params, cfg, ps, rows[a]["outputs"],
                          rows[a + 1]["outputs"],
                          f"{rows[a]['case']}, k={rows[a + 1]['k']} against 0")
                for a, ps in zip((0, 2), sp.prompts(
                    np.random.default_rng(0), cfg.vocab_size,
                    len(rows[0]["outputs"]), sp.parse_args([]).prompt))]
        del params
        return "; ".join(f"{r['case']} k={r['k']} {r['tok_per_s']:.1f} tok/s"
                         f" ({r['tokens_per_dispatch']:.3f} a dispatch)"
                         for r in rows) + "; " + "; ".join(ties)
    if name == "attribution":
        vals = [out[k] for k in ("matmul_s", "attn_s", "full_s",
                                 "glue_alone_s")]
        if not all(math.isfinite(v) and v > 0 for v in vals) or \
                max(out["matmul_eff"], out["attn_eff"]) > 1.05:
            raise AssertionError(f"phase 5h: attribution {out}")
        return (f"matmul {out['matmul_s'] * 1e3:.3f} ms "
                f"({out['matmul_eff']:.3f} of its floor), attention "
                f"{out['attn_s'] * 1e3:.3f} ms ({out['attn_eff']:.3f}), glue "
                f"{out['glue_s'] * 1e3:.3f} ms (alone "
                f"{out['glue_alone_s'] * 1e3:.3f}), step "
                f"{out['full_s'] * 1e3:.3f} ms")
    if name == "probe_step_overhead":
        rows = out["ms_per_step"]
        if not all(v > 0 for v in rows.values()):
            raise AssertionError(f"phase 5h: probe_step_overhead {out}")
        return "; ".join(f"{k} {v:.3f} ms" for k, v in rows.items())
    arms = {k: out[k] for k in ("full", "int8", "k1", "bf16")}
    if any(v is None or v["of_peak"] > 1.05 for v in arms.values()):
        raise AssertionError(f"phase 5h: probe_prefill {out}")
    return "; ".join(f"{k} {v['ms']:.2f} ms ({v['of_peak']:.3f} of peak)"
                     for k, v in arms.items())


def bench_runs(dev) -> dict:
    """Phase 5h (--benches): each bench module's main([]) at its defaults
    (bench/serving7b, bench/speculative, bench/attribution,
    bench/probe_step_overhead, bench/probe_prefill), each printing its JSON
    line, its launches counted over the whole call and held to BENCHES,
    its result to bench_check; then utils/profiling's dispatch_overhead
    and fusion_benefit. Returns the benches' launches."""
    import importlib

    from physics_llm_inference_tpu_torch.utils import profiling

    counts, failed = {k: 0 for k in KERNELS}, []
    for name, expect in BENCHES:
        mod = importlib.import_module(f"{PKG}.bench.{name}")
        reset_launches()
        t0 = time.perf_counter()
        out = mod.main([])
        secs = time.perf_counter() - t0
        c = read_launches()
        release()
        for k in KERNELS:
            counts[k] += c[k]
        try:
            missing = [k for k in expect if c[k] == 0]
            if missing:
                raise AssertionError(f"phase 5h: bench/{name} launched none "
                                     f"of {missing}")
            line = bench_check(name, out)
        except AssertionError as e:     # logged, then raised below
            failed.append(str(e))
            line = f"FAILED: {e}"
        log(f"phase 5h bench/{name} ({nvidia_smi()}; {secs:.1f} s): {line};"
            f" launches { {k: v for k, v in c.items() if v} }")
    log(f"phase 5h utils/profiling ({nvidia_smi()}): dispatch_overhead "
        f"{json.dumps(profiling.dispatch_overhead())}; fusion_benefit "
        f"{json.dumps(profiling.fusion_benefit())}")
    if failed:
        raise AssertionError(" | ".join(failed))
    return counts


def release() -> None:
    """Return this process's free cached blocks to the card. A phase's
    tensors can outlive it in reference cycles (a frame of a caught
    exception's traceback holds its locals), and one small tensor left in
    a large cached segment keeps the whole segment: collect them first."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def log_memory(after: str) -> dict:
    """What this process still holds on the card after a phase, read
    through utils/profiling.device_memory_stats: allocated and reserved,
    and the largest free block that keeps a cached segment. Returns the
    stats."""
    from physics_llm_inference_tpu_torch.utils.profiling import \
        device_memory_stats

    st = device_memory_stats()
    log(f"after {after}: {st['bytes_in_use'] / 2**30:.2f} GiB allocated, "
        f"{st['reserved_bytes'] / 2**30:.2f} GiB reserved (largest free "
        f"block inside a segment in use "
        f"{st['largest_inactive_split_bytes'] / 2**30:.2f} GiB; "
        f"device_memory_stats)")
    return st


def memory_after_5e() -> None:
    """After phase 5e (and release()) the process may hold at most 2 GiB
    reserved above what it has allocated."""
    st = log_memory("phase 5e")
    if st["reserved_bytes"] > st["bytes_in_use"] + (2 << 30):
        raise AssertionError("after phase 5e the process holds "
                             f"{st['reserved_bytes'] / 2**30:.2f} GiB "
                             "reserved, more than 2 GiB above the "
                             f"{st['bytes_in_use'] / 2**30:.2f} GiB allocated")


def timed(phase: str, fn, *a, **kw):
    """fn(*a, **kw), its seconds logged under `phase`."""
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=()) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG} not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    log(nvidia_smi())
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")

    from physics_llm_inference_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    reports = {}
    # built from the sources every run: a library left by an earlier run
    # would skip nvcc, whose ptxas report phases 2 and 5e read
    _build.LIB_PATH.unlink(missing_ok=True)
    _build.build(ptxas=reports)
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.LIB_PATH}")
    for line in ptxas_report(reports):
        log(line)

    parts = set(argv) & {"--k1", "--attention", "--fused", "--decode",
                         "--serving", "--frontend", "--copy", "--moe",
                         "--accuracy", "--parallel", "--capture",
                         "--train", "--benches", "--determinism"}
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    if parts:
        # parts alone, for comparing trees: K1 in phase 3; K2, K6 and K7
        # in phase 3; K4 in each mode, K8 and the phase clock; decode at
        # prompt 128 in each K4 mode; the bench_serving7b wave
        if "--attention" in argv:
            check_k2(dev, flush, torch.Generator(device=dev).manual_seed(SEED))
            check_paged_attention(dev, flush)
        if "--k1" in argv:
            check_k1(dev, flush, torch.Generator(device=dev).manual_seed(SEED))
            check_k3(dev, flush, torch.Generator(device=dev).manual_seed(SEED))
        if "--copy" in argv:
            check_teaching(dev, flush)
        if "--moe" in argv:
            log(json.dumps({"kernels": [{"name": "moe_experts",
                                         **check_moe_experts(dev, flush)}]}))
        if "--fused" in argv:
            for mode in FUSED_MODES:
                check_fused(dev, flush, mode)
            fused_seeds(dev, flush)
            check_fused_capture(dev)
            check_fused_paged(dev, flush)
        del flush
        torch.cuda.empty_cache()
        if "--fused" in argv:
            phase_clock(dev)
        if "--decode" in argv:
            decode_alone(dev)
        if "--serving" in argv:
            serving_alone(dev)
        if "--frontend" in argv:
            frontend_alone(dev)
        if "--moe" in argv:
            moe_runs(dev)
        if "--accuracy" in argv:
            accuracy_runs(dev, reports)
            release()
            memory_after_5e()
        if "--parallel" in argv:
            parallel_runs(dev)
        if "--determinism" in argv:
            # --determinism {replay,eager,interleave} N: K4 W8A16 alone,
            # N launches of the form(s), each bit-equal to the first
            i = argv.index("--determinism")
            form, n = argv[i + 1], int(argv[i + 2])
            determinism_alone(dev, form, n)
        failed = []
        for flag, phase, fn in (("--capture", "A (--capture)", capture_runs),
                                ("--train", "5g", train_runs),
                                ("--benches", "5h", bench_runs)):
            if flag in argv:
                try:
                    timed(phase, fn, dev)
                except AssertionError as e:     # logged, then raised below
                    failed.append(f"{flag}: {e}")
                    log(f"{flag} failed: {e}")
                release()
        log(nvidia_smi())
        if failed:
            raise AssertionError(" || ".join(failed))
        return 0
    kernels = timed("3", check_kernels, dev, flush)
    del flush
    torch.cuda.empty_cache()
    timed("3b", phase_clock, dev)
    t0 = time.perf_counter()
    slice_parity(dev, fused=False)
    for mode in FUSED_MODES:
        slice_parity(dev, fused=True, mode=mode)
    paged_slice_parity(dev)
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    dense, params, step_ms = timed("5 (cached_generate, headline)",
                                   full_runs, dev)
    paged = timed("5 (paged engine)", serving_runs, dev, params)
    timed("A (captured steps against eager)", capture_runs, dev, params,
          **FULL_RUN_CAPTURE)
    front = timed("5c", frontend_runs, dev, params, step_ms)
    del params
    release()
    log_memory("phase 5c")
    moe = timed("5d", moe_runs, dev)
    release()
    log_memory("phase 5d")
    acc = timed("5e", accuracy_runs, dev, reports)
    release()
    memory_after_5e()
    par = timed("5f", parallel_runs, dev)
    release()
    trained = timed("5g", train_runs, dev)
    release()
    benches = timed("5h", bench_runs, dev)
    release()
    micro = timed("6", micro_path, dev)
    counts = {k: dense[k] + paged[k] + front[k] + moe[k] + acc[k] + par[k]
              + trained[k] + benches[k] + micro[k] for k in KERNELS}

    rows = []
    for name, row in kernels.items():
        _, _, src, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": f"{PKG}/{src}",
                     "replaces": replaces, "launches": counts[name], **row})
    log(nvidia_smi())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
