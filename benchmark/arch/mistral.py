"""The Mistral-shaped decoder (`model_type` "mistral"; Mixtral's
"mixtral" re-exports it): the port's ModelConfig for its configuration
file, its weights from the seed, its plain float32 reference and the
operations and bytes of its steps. The interface is lib/spec.py's.

Weights: int8 codes and f32 per-output-channel scales for every block
matrix and the LM head (the served format, W8A16); embeddings, norm
weights and router gates in the activation dtype; made on the device by
one `torch.Generator` in a few large calls. `weights()` returns them as
plain tensors under the benchmark's own names; `program_params()` wraps
the same tensors in the port's parameter dict, so both sides read one
copy.

Reference: the published forward pass in float32, in plain torch, over
whole sequences (no cache, no batching, no kernels), importing nothing of
the port, with the int8 weight and cache formats of lib/plain.py.
Activations are float32 with TF32 off. Mistral (arXiv:2310.06825):
RMSNorm, RoPE with rotate-half, grouped-query attention, SwiGLU. Mixtral
(arXiv:2401.04088): the FFN is a router over experts, softmax, top-k, the
k weights renormalised, each a SwiGLU. `int4=True` is the control (every
int8 matrix re-quantized to int4); `bf16=True` is a witness, not a
reference: each product's inputs and output rounded to bfloat16 (the
router's logits included).

Work: every layer alike, full attention over the whole context, one FFN
kind (dense SwiGLU, or top-k of `num_local_experts`), and int8 KV of one
key and one value a KV head.
"""
from __future__ import annotations

import torch

from benchmark.lib.plain import (dequant, f32_matmuls, kv_int8, mm_bf16,
                                 rms, rope)
from benchmark.lib.weights import generator, int8_matrix, uniform


def model_config(config: dict):
    """The port's ModelConfig for a configuration file (Hugging Face keys)."""
    from physics_llm_inference_tpu_torch.models.config import ModelConfig

    d, heads = config["hidden_size"], config["num_attention_heads"]
    hd = config.get("head_dim") or d // heads
    assumed = config.get("assumed", {})
    return ModelConfig(
        vocab_size=config["vocab_size"], hidden_dim=d,
        num_layers=config["num_hidden_layers"], num_heads=heads,
        num_kv_heads=config["num_key_value_heads"],
        intermediate_dim=config["intermediate_size"],
        norm_eps=config["rms_norm_eps"], rope_theta=config["rope_theta"],
        max_seq_len=config["max_position_embeddings"],
        dtype=config["precision"]["activations"],
        num_experts=config.get("num_local_experts", 0),
        num_experts_per_tok=config.get("num_experts_per_tok", 2),
        expert_capacity_factor=assumed.get("expert_capacity_factor", 1.25),
        head_dim_override=None if hd * heads == d else hd)


def shapes(config: dict) -> dict:
    """name -> (K, N) of each block matrix, or (E, K, N) of an expert
    stack (per layer), in the layout x @ w."""
    d = config["hidden_size"]
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or d // hq
    f = config["intermediate_size"]
    out = {"wqkv": (d, (hq + 2 * hkv) * hd), "wo": (hq * hd, d)}
    e = config.get("num_local_experts", 0)
    if e:
        out.update({"moe_w1": (e, d, f), "moe_w3": (e, d, f),
                    "moe_w2": (e, f, d)})
    else:
        out.update({"w_gate_up": (d, 2 * f), "w_down": (f, d)})
    return out


def weights(config: dict, seed: int, device) -> dict:
    """The model's weights from `seed`: int8 codes `<name>.q` and f32
    scales `<name>.s` (lib/weights.int8_matrix, one per layer and output
    channel) for each block matrix and `lm_head`; `embed`, `norm`, `ln1`,
    `ln2` (norm weights in [0.8, 1.2]) and, for experts, `moe_gate` in the
    activation dtype."""
    g = generator(seed, device)
    L, d, v = (config["num_hidden_layers"], config["hidden_size"],
               config["vocab_size"])
    act = getattr(torch, config["precision"]["activations"])
    w = {"embed": torch.randn((v, d), generator=g, device=device,
                              dtype=act).mul_(d ** -0.5),
         "norm": uniform(g, (d,), 0.8, 1.2, act),
         "ln1": uniform(g, (L, d), 0.8, 1.2, act),
         "ln2": uniform(g, (L, d), 0.8, 1.2, act)}
    for name, shape in shapes(config).items():
        w[name + ".q"], w[name + ".s"] = int8_matrix(g, (L, *shape[:-2]),
                                                     *shape[-2:])
    if config.get("num_local_experts", 0):
        w["moe_gate"] = torch.randn(
            (L, d, config["num_local_experts"]), generator=g, device=device,
            dtype=act).mul_(d ** -0.5)
    q, s = int8_matrix(g, (), d, v)
    w["lm_head.q"], w["lm_head.s"] = q, s
    return w


def program_params(w: dict) -> dict:
    """The port's parameter dict over the same tensors."""
    from physics_llm_inference_tpu_torch.models.quant import QuantizedTensor

    blocks = {"ln1": w["ln1"], "ln2": w["ln2"]}
    for key in w:
        if key.endswith(".q") and key != "lm_head.q":
            name = key[:-2]
            blocks[name] = QuantizedTensor(w[key], w[name + ".s"])
    if "moe_gate" in w:
        blocks["moe_gate"] = w["moe_gate"]
    return {"embed": w["embed"], "norm": w["norm"], "blocks": blocks,
            "lm_head": QuantizedTensor(w["lm_head.q"], w["lm_head.s"])}


def weight_bytes(w: dict) -> dict:
    """Bytes of the weights by part: `layer` (per layer, the expert stacks
    apart in `expert_layer`), `lm_head`, `norm`, `embed_row` (one row)."""
    L = w["ln1"].shape[0]
    nbytes = {k: t.numel() * t.element_size() for k, t in w.items()}
    experts = sum(n for k, n in nbytes.items() if k.startswith("moe_w"))
    blocks = sum(n for k, n in nbytes.items()
                 if k.split(".")[0] in ("ln1", "ln2", "wqkv", "wo",
                                        "w_gate_up", "w_down", "moe_gate"))
    return {"layer": blocks / L, "expert_layer": experts / L,
            "lm_head": nbytes["lm_head.q"] + nbytes["lm_head.s"],
            "norm": nbytes["norm"],
            "embed_row": w["embed"].shape[1] * w["embed"].element_size()}


class Work:
    """Operations and compulsory bytes of a model's steps, from shapes and
    from the inputs actually used (the live KV, the valid tokens, the
    experts routed to). Nothing counts what a kernel happens to read again
    or pad."""

    def __init__(self, config: dict, wbytes: dict):
        c = config
        self.L = c["num_hidden_layers"]
        self.d = c["hidden_size"]
        self.hq = c["num_attention_heads"]
        self.hkv = c["num_key_value_heads"]
        self.hd = c.get("head_dim") or self.d // self.hq
        self.f = c["intermediate_size"]
        self.v = c["vocab_size"]
        self.e = c.get("num_local_experts", 0)
        self.k = c.get("num_experts_per_tok", 0)
        self.wb = wbytes
        qkv = self.d * (self.hq + 2 * self.hkv) * self.hd
        attn = qkv + self.hq * self.hd * self.d
        ffn = (self.e * self.d + self.k * 3 * self.d * self.f if self.e
               else 3 * self.d * self.f)
        # matrix parameters a token meets in one layer
        self.layer_params = attn + ffn
        self.linear_params = attn + (0 if self.e else 3 * self.d * self.f)
        # int8 KV: one key and one value a KV head, each hd codes and an
        # f32 scale, per layer
        self.kv_bytes = 2 * self.hkv * (self.hd + 4)

    def experts_touched(self, rows: int) -> int | None:
        """Experts a layer's step of `rows` tokens reads: all of them, unless
        the chance that one goes unrouted is not negligible (then None: the
        count needs the program's routing)."""
        if not self.e:
            return 0
        if self.e * (1 - self.k / self.e) ** rows > 1e-3:
            return None
        return self.e

    def layer_weight_bytes(self, rows: int) -> float | None:
        """Weight bytes one layer's step reads for `rows` tokens."""
        if not self.e:
            return self.wb["layer"]
        touched = self.experts_touched(rows)
        if touched is None:
            return None
        return self.wb["layer"] + self.wb["expert_layer"] * touched / self.e

    def attn_flops(self, q_tokens_ctx: int) -> float:
        """QK^T and PV over every layer for a total of `q_tokens_ctx`
        (query, key) pairs."""
        return 4.0 * self.L * self.hq * self.hd * q_tokens_ctx

    def decode(self, contexts: list) -> tuple[float, float] | None:
        """(FLOPs, bytes) of one decode step of the whole model, head
        included, for rows whose cache holds `contexts` keys before the
        step (each attends its context and its new token)."""
        rows = len(contexts)
        lw = self.layer_weight_bytes(rows)
        if lw is None:
            return None
        live = sum(contexts)
        flops = (2.0 * rows * (self.L * self.layer_params + self.d * self.v)
                 + self.attn_flops(live + rows))
        nbytes = (self.L * lw + self.wb["lm_head"] + self.wb["norm"]
                  + rows * self.wb["embed_row"]
                  + self.L * self.kv_bytes * (live + rows))
        return flops, nbytes

    def fused_decode_bytes(self, contexts: list) -> float:
        """Bytes of one K4/K8 launch (every layer, no head): the block
        weights, the live KV read and the new KV written."""
        return (self.L * self.wb["layer"]
                + self.L * self.kv_bytes * (sum(contexts) + len(contexts)))

    def prefill(self, chunks: list) -> tuple[float, float] | None:
        """(FLOPs, bytes) of a prefill over `chunks`, each (start, n): n
        valid tokens after `start` cached ones; the head on each chunk's
        last token."""
        tokens = sum(n for _, n in chunks)
        lw = self.layer_weight_bytes(tokens)
        if lw is None:
            return None
        pairs = sum(n * s + n * (n + 1) // 2 for s, n in chunks)
        flops = (2.0 * tokens * self.L * self.layer_params
                 + 2.0 * len(chunks) * self.d * self.v
                 + self.attn_flops(pairs))
        nbytes = (self.L * lw + self.wb["lm_head"]
                  + tokens * self.wb["embed_row"]
                  + self.L * self.kv_bytes * sum(s + n for s, n in chunks))
        return flops, nbytes

    def prefill_linear_flops(self, chunks: list) -> float:
        """FLOPs of the dense block linears and the head in a prefill."""
        tokens = sum(n for _, n in chunks)
        return (2.0 * tokens * self.L * self.linear_params
                + 2.0 * len(chunks) * self.d * self.v)

    def expert_bytes(self, rows: int) -> float | None:
        """Expert weight bytes one layer's step reads for `rows` tokens."""
        touched = self.experts_touched(rows)
        if touched is None:
            return None
        return self.wb["expert_layer"] * touched / self.e


def _attention(x, wqkv, wo, config, mm):
    n = x.shape[0]
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or config["hidden_size"] // hq
    q, k, v = mm(x, wqkv).split([hq * hd, hkv * hd, hkv * hd], dim=-1)
    q = rope(q.reshape(n, hq, hd), config["rope_theta"])
    k = kv_int8(rope(k.reshape(n, hkv, hd), config["rope_theta"]))
    v = kv_int8(v.reshape(n, hkv, hd))
    rep = hq // hkv
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)     # (Hq, T, hd)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    scores = q.transpose(0, 1) @ k.transpose(1, 2) * hd ** -0.5
    causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v                  # (Hq, T, hd)
    return mm(out.transpose(0, 1).reshape(n, hq * hd), wo)


def _swiglu(h, w_in_gate, w_in_up, w_out, mm):
    return mm(torch.nn.functional.silu(mm(h, w_in_gate))
               * mm(h, w_in_up), w_out)


def _moe(h, w, layer, config, int4, mm):
    """Top-k routed SwiGLU experts; each expert dequantized in turn."""
    k = config["num_experts_per_tok"]
    probs = torch.softmax(mm(h, w["moe_gate"][layer].float()), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    top = top / top.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(config["num_local_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        w1, w3, w2 = (dequant(w[f"{n}.q"][layer, e], w[f"{n}.s"][layer, e],
                              int4) for n in ("moe_w1", "moe_w3", "moe_w2"))
        y = _swiglu(h[rows], w1, w3, w2, mm)
        out.index_add_(0, rows, y * top[rows, slot][:, None])
    return out


@torch.no_grad()
def logits(w: dict, config: dict, seqs: list, positions: list,
           int4: bool = False, bf16: bool = False) -> list:
    """For each token sequence `seqs[i]` (a list of ids), the float32 logits
    (len(positions[i]), V) at `positions[i]`: the prediction of the token
    after each of those positions. Layer by layer over all sequences, so
    each layer's weights are made float32 once."""
    f32_matmuls()
    mm = mm_bf16 if bf16 else torch.matmul
    dev = w["embed"].device
    eps = config["rms_norm_eps"]
    xs = [w["embed"][torch.as_tensor(s, device=dev)].float() for s in seqs]
    moe = config.get("num_local_experts", 0) > 0
    for layer in range(config["num_hidden_layers"]):
        wqkv = dequant(w["wqkv.q"][layer], w["wqkv.s"][layer], int4)
        wo = dequant(w["wo.q"][layer], w["wo.s"][layer], int4)
        if not moe:
            gu = dequant(w["w_gate_up.q"][layer], w["w_gate_up.s"][layer],
                         int4)
            gate, up = gu.chunk(2, dim=-1)
            down = dequant(w["w_down.q"][layer], w["w_down.s"][layer], int4)
        for i, x in enumerate(xs):
            x = x + _attention(rms(x, w["ln1"][layer], eps), wqkv, wo,
                               config, mm)
            h = rms(x, w["ln2"][layer], eps)
            x = x + (_moe(h, w, layer, config, int4, mm) if moe
                     else _swiglu(h, gate, up, down, mm))
            xs[i] = x
        del wqkv, wo
        if not moe:
            del gu, gate, up, down
    head = dequant(w["lm_head.q"], w["lm_head.s"], int4)
    out = []
    for x, pos in zip(xs, positions):
        idx = torch.as_tensor(pos, device=dev)
        out.append(mm(rms(x[idx], w["norm"], eps), head))
    return out
