"""What the architecture module makes and counts is what the harness made
and counted before configurations brought their own modules: weights bit
for bit, the reference's, the control's and the witness's logits bit for
bit, the port's ModelConfig and parameter dict, and every Work count.

The recorded values (golden_mistral.json) were taken from the harness's
own code on the CPU (PyTorch 2.13, one thread), dense and MoE, at the toy
sizes; each count also at the two published configurations with byte
sizes given by hand.
"""
import hashlib
import json
from dataclasses import asdict
from pathlib import Path

import pytest
import torch

from benchmark.tests import toy

HERE = Path(__file__).resolve().parent
GOLDEN = HERE / "golden_mistral.json"
SEED = 2**31 + 77
# top-2 of 4: some experts go unrouted for some tokens
MOE4 = dict(toy.MOE, num_local_experts=4)
CONFIGS = {"dense": toy.CONFIG, "moe": toy.MOE, "moe4": MOE4}
PUBLISHED = {
    name: json.loads((HERE.parent / "configs" / f"{name}.json").read_text())
    for name in ("mistral-7b-v0.3", "mixtral-8x7b-v0.1")}
PUBLISHED_BYTES = {"layer": 218_234_880.0, "expert_layer": 1_409_548_288.0,
                   "lm_head": 134_348_800.0, "norm": 8192.0,
                   "embed_row": 8192.0}


def _digest(t: torch.Tensor) -> str:
    t = t.detach().cpu().contiguous()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:24] + \
        f" {t.dtype} {tuple(t.shape)}"


def _sequences(vocab: int) -> tuple[list, list]:
    g = torch.Generator().manual_seed(5)
    lens = (21, 40, 9)
    seqs = [torch.randint(1, vocab, (n,), generator=g).tolist()
            for n in lens]
    positions = [list(range(n - 6, n)) for n in lens]
    return seqs, positions


def _counts(work) -> dict:
    out = {"L": work.L, "d": work.d, "e": work.e,
           "layer_params": work.layer_params,
           "linear_params": work.linear_params, "kv_bytes": work.kv_bytes}
    for rows in (1, 4, 64):
        out[f"experts_touched({rows})"] = work.experts_touched(rows)
        out[f"layer_weight_bytes({rows})"] = work.layer_weight_bytes(rows)
        out[f"expert_bytes({rows})"] = (work.expert_bytes(rows) if work.e
                                        else None)
    for ctx in ([3, 5], [1, 2, 3, 4], [100 + i for i in range(64)]):
        key = f"{len(ctx)}x{ctx[0]}"
        out[f"decode({key})"] = work.decode(ctx)
        out[f"fused_decode_bytes({key})"] = work.fused_decode_bytes(ctx)
    for chunks in ([(0, 5), (2, 3)], [(0, 100 + i) for i in range(64)]):
        key = f"{len(chunks)}x{chunks[0][1]}"
        out[f"prefill({key})"] = work.prefill(chunks)
        out[f"prefill_linear_flops({key})"] = \
            work.prefill_linear_flops(chunks)
    return json.loads(json.dumps(out))


def values(arch) -> dict:
    """Every value the golden file records, from the module `arch`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name, config in CONFIGS.items():
            w = arch.weights(config, SEED, torch.device("cpu"))
            blocks = arch.program_params(w)["blocks"]
            seqs, pos = _sequences(config["vocab_size"])
            wb = arch.weight_bytes(w)
            out[name] = {
                "weights": {k: _digest(t) for k, t in sorted(w.items())},
                "weight_bytes": wb,
                "model_config": json.loads(json.dumps(
                    asdict(arch.model_config(config)))),
                "blocks": sorted(blocks),
                "counts": _counts(arch.Work(config, wb)),
            }
            for kind, kw in (("reference", {}), ("control", {"int4": True}),
                             ("witness", {"bf16": True})):
                out[name][kind] = [_digest(x) for x in
                                   arch.logits(w, config, seqs, pos, **kw)]
        for name, config in PUBLISHED.items():
            out[name] = {"counts": _counts(arch.Work(config,
                                                     PUBLISHED_BYTES))}
        return out
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def got():
    from benchmark.arch import mistral

    return values(mistral)


GOLDEN_VALUES = json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("name", sorted(GOLDEN_VALUES))
def test_nothing_moved(got, name):
    want = GOLDEN_VALUES[name]
    assert set(got[name]) == set(want)
    for part in want:
        assert got[name][part] == want[part], (name, part)


def test_program_params_wrap_the_weights_themselves():
    from benchmark.arch import mistral

    w = mistral.weights(toy.MOE, 3, torch.device("cpu"))
    p = mistral.program_params(w)
    assert p["embed"] is w["embed"] and p["norm"] is w["norm"]
    assert p["lm_head"].q is w["lm_head.q"]
    for name in ("wqkv", "wo", "moe_w1", "moe_w3", "moe_w2"):
        assert p["blocks"][name].q is w[name + ".q"]
        assert p["blocks"][name].s is w[name + ".s"]
    assert p["blocks"]["moe_gate"] is w["moe_gate"]
