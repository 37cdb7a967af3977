"""DeepSeek-V2 (`model_type` "deepseek_v2"; arXiv:2405.04434, the model's
modeling_deepseek.py): the port's ModelConfig for its configuration file,
its weights from the seed, its plain float32 reference and the operations
and bytes of its steps. The interface is lib/spec.py's.

Weights: int8 codes and f32 per-output-channel scales for every block
matrix and the LM head (W8A16); embeddings, norm weights (RMSNorm's and
the latent's `kv_a_layernorm`) and router gates in the activation dtype;
made on the device by one `torch.Generator` in a few large calls.
`weights()` returns them as plain tensors under the benchmark's own names;
`program_params()` wraps the same tensors in the port's parameter dict, so
both sides read one copy. The first `first_k_dense_replace` layers hold a
dense SwiGLU of `intermediate_size`, the rest `n_routed_experts` of
`moe_intermediate_size` and one shared SwiGLU of `n_shared_experts` times
that width.

Reference: the published forward pass in float32, in plain torch, over
whole sequences (no cache, no batching, no kernels), importing nothing of
the port. Multi-head latent attention without q-LoRA: q = h Wq (per head
128 nope + 64 rope dims); (c, k_pe) = h W_kv_a; c = RMSNorm(c); q_pe and
k_pe de-interleaved (pairs (0, 1), (2, 3), ... become halves), then
rotate-half RoPE on YaRN's frequencies; k_nope, v = c W_kv_b; softmax
scale 192^-0.5 x mscale(40, 0.707)^2; then W_o. The latent and the rotated
rope key pass through the int8 cache format (per token, absmax / 127, the
format the program's latent cache holds) before W_kv_b and the scores.
The FFN: dense SwiGLU, or an f32 gate, softmax, the greedy top-k (not
renormalised: times `routed_scaling_factor`), each expert a SwiGLU, plus
the shared SwiGLU. `int4=True` is the control (every int8 matrix
re-quantized to int4 in groups of 128 input rows; the dense layer's
W_down, whose 10,944 rows 128 does not divide, in groups of 64: 10,944 =
171 x 64); `bf16=True` is the bf16 witness (every product's inputs and
output rounded to bfloat16, the router's included).

Work: MLA decode absorbed (q_nope through W_UK into the 512-wide latent,
one 576-wide head of latent and rope key read by all 16 query heads, the
output through W_UV), MLA prefill decompressed (q/k 192, v 128 a head), a
latent cache of 512 + 64 int8 codes and two f32 scales a token and layer,
the dense first layer, the shared experts, and the routed experts a step
touches: all 64 unless their count is not sure, then the expectation under
uniform routing. Only the counts the readers of an offline cell read are
here: no `fused_decode_bytes` (K4 does not run this model),
`layer_weight_bytes` or `prefill_linear_flops` (serving readers).
"""
from __future__ import annotations

import math

import torch

from benchmark.lib.plain import (INT4_GROUP, dequant, f32_matmuls, kv_int8,
                                 mm_bf16, rms)
from benchmark.lib.weights import generator, int8_matrix, uniform

# the int4 control's group where 128 does not divide a matrix's rows
INT4_GROUP_SMALL = 64


def _dims(c: dict) -> dict:
    h = c["num_attention_heads"]
    return {"d": c["hidden_size"], "h": h, "r": c["kv_lora_rank"],
            "dn": c["qk_nope_head_dim"], "dr": c["qk_rope_head_dim"],
            "dv": c["v_head_dim"], "f": c["moe_intermediate_size"],
            "fd": c["intermediate_size"],
            "fs": c["moe_intermediate_size"] * c["n_shared_experts"],
            "e": c["n_routed_experts"], "k": c["num_experts_per_tok"],
            "L": c["num_hidden_layers"], "ld": c["first_k_dense_replace"],
            "v": c["vocab_size"]}


def model_config(config: dict):
    """The port's ModelConfig (a DeepSeekV2Config) for a configuration file
    (Hugging Face keys)."""
    from physics_llm_inference_tpu_torch.models.config import (
        DeepSeekV2Config, YarnScaling)

    c, n = config, _dims(config)
    rs = c["rope_scaling"]
    yarn = YarnScaling(
        factor=rs["factor"],
        original_max_position_embeddings=rs[
            "original_max_position_embeddings"],
        beta_fast=rs["beta_fast"], beta_slow=rs["beta_slow"],
        mscale=rs["mscale"], mscale_all_dim=rs["mscale_all_dim"])
    return DeepSeekV2Config(
        vocab_size=n["v"], hidden_dim=n["d"], num_layers=n["L"],
        num_heads=n["h"], num_kv_heads=c["num_key_value_heads"],
        intermediate_dim=n["f"], norm_eps=c["rms_norm_eps"],
        rope_theta=float(c["rope_theta"]),
        max_seq_len=c["max_position_embeddings"],
        dtype=c["precision"]["activations"], num_experts=n["e"],
        num_experts_per_tok=n["k"],
        expert_capacity_factor=c["assumed"]["expert_capacity_factor"],
        router_f32=True, norm_topk_prob=c["norm_topk_prob"],
        routed_scaling_factor=float(c["routed_scaling_factor"]),
        shared_expert_dim=n["fs"], first_k_dense_replace=n["ld"],
        dense_intermediate_dim=n["fd"], kv_lora_rank=n["r"],
        qk_nope_head_dim=n["dn"], qk_rope_head_dim=n["dr"],
        v_head_dim=n["dv"], rope_yarn=yarn)


def shapes(config: dict) -> dict:
    """name -> (lead, K, N) of each int8 block matrix stack, in the layout
    x @ w: lead is (layers,) or (layers, experts)."""
    n = _dims(config)
    L, ld, lm = n["L"], n["ld"], n["L"] - n["ld"]
    return {
        "wq": ((L,), n["d"], n["h"] * (n["dn"] + n["dr"])),
        "wkv_a": ((L,), n["d"], n["r"] + n["dr"]),
        "wkv_b": ((L,), n["r"], n["h"] * (n["dn"] + n["dv"])),
        "wo": ((L,), n["h"] * n["dv"], n["d"]),
        "w_gate_up": ((ld,), n["d"], 2 * n["fd"]),
        "w_down": ((ld,), n["fd"], n["d"]),
        "moe_w1": ((lm, n["e"]), n["d"], n["f"]),
        "moe_w3": ((lm, n["e"]), n["d"], n["f"]),
        "moe_w2": ((lm, n["e"]), n["f"], n["d"]),
        "shared_w_gate_up": ((lm,), n["d"], 2 * n["fs"]),
        "shared_w_down": ((lm,), n["fs"], n["d"]),
    }


def weights(config: dict, seed: int, device) -> dict:
    """The model's weights from `seed`: int8 codes `<name>.q` and f32
    scales `<name>.s` (lib/weights.int8_matrix) for each block matrix and
    `lm_head`; `embed`, `norm`, `ln1`, `ln2`, `kv_ln` (norm weights in
    [0.8, 1.2]) and `moe_gate` in the activation dtype."""
    g = generator(seed, device)
    n = _dims(config)
    L, d = n["L"], n["d"]
    act = getattr(torch, config["precision"]["activations"])
    w = {"embed": torch.randn((n["v"], d), generator=g, device=device,
                              dtype=act).mul_(d ** -0.5),
         "norm": uniform(g, (d,), 0.8, 1.2, act),
         "ln1": uniform(g, (L, d), 0.8, 1.2, act),
         "ln2": uniform(g, (L, d), 0.8, 1.2, act),
         "kv_ln": uniform(g, (L, n["r"]), 0.8, 1.2, act)}
    for name, (lead, k, m) in shapes(config).items():
        w[name + ".q"], w[name + ".s"] = int8_matrix(g, lead, k, m)
    w["moe_gate"] = torch.randn((L - n["ld"], d, n["e"]), generator=g,
                                device=device, dtype=act).mul_(d ** -0.5)
    w["lm_head.q"], w["lm_head.s"] = int8_matrix(g, (), d, n["v"])
    return w


def program_params(w: dict) -> dict:
    """The port's parameter dict over the same tensors."""
    from physics_llm_inference_tpu_torch.models.quant import QuantizedTensor

    blocks = {k: w[k] for k in ("ln1", "ln2", "kv_ln", "moe_gate")}
    for key in w:
        if key.endswith(".q") and key != "lm_head.q":
            name = key[:-2]
            blocks[name] = QuantizedTensor(w[key], w[name + ".s"])
    return {"embed": w["embed"], "norm": w["norm"], "blocks": blocks,
            "lm_head": QuantizedTensor(w["lm_head.q"], w["lm_head.s"])}


def _nbytes(w: dict, *names) -> int:
    return sum(w[f"{n}.{p}"].numel() * w[f"{n}.{p}"].element_size()
               for n in names for p in ("q", "s"))


def weight_bytes(w: dict) -> dict:
    """Bytes of the weights by part: `attn_layer` (a layer's attention
    matrices and norm weights), `dense_layer` (a dense layer's FFN),
    `moe_layer` (an MoE layer's gate and shared experts), `expert_layer`
    (an MoE layer's routed stacks), `lm_head`, `norm`, `embed_row` (one
    row)."""
    L = w["ln1"].shape[0]
    ld = w["w_gate_up.q"].shape[0]
    lm = L - ld
    norms = sum(w[k].numel() * w[k].element_size()
                for k in ("ln1", "ln2", "kv_ln"))
    gate = w["moe_gate"].numel() * w["moe_gate"].element_size()
    return {"attn_layer": (_nbytes(w, "wq", "wkv_a", "wkv_b", "wo")
                           + norms) / L,
            "dense_layer": _nbytes(w, "w_gate_up", "w_down") / max(ld, 1),
            "moe_layer": (gate + _nbytes(w, "shared_w_gate_up",
                                         "shared_w_down")) / max(lm, 1),
            "expert_layer": _nbytes(w, "moe_w1", "moe_w3", "moe_w2")
            / max(lm, 1),
            "lm_head": _nbytes(w, "lm_head"),
            "norm": w["norm"].numel() * w["norm"].element_size(),
            "embed_row": w["embed"].shape[1] * w["embed"].element_size()}


class Work:
    """Operations and compulsory bytes of the model's steps, from shapes
    and from the inputs actually used (the live latent cache, the valid
    tokens, the experts routed to). Nothing counts what a kernel happens to
    read again or pad."""

    def __init__(self, config: dict, wbytes: dict):
        n = _dims(config)
        self.n = n
        self.L, self.d, self.e, self.k = n["L"], n["d"], n["e"], n["k"]
        self.ld, self.lm = n["ld"], n["L"] - n["ld"]
        self.moe_layers = self.lm
        self.v = n["v"]
        self.wb = wbytes
        d, h = n["d"], n["h"]
        # matrix parameters a token meets in one layer's attention (W_kv_b
        # once: decompressing one token's latent, or absorbing its query
        # and output, is the same products' count)
        self.attn_params = (d * h * (n["dn"] + n["dr"])
                            + d * (n["r"] + n["dr"])
                            + n["r"] * h * (n["dn"] + n["dv"])
                            + h * n["dv"] * d)
        self.dense_params = 3 * d * n["fd"]
        self.moe_params = (d * n["e"] + n["k"] * 3 * d * n["f"]
                           + 3 * d * n["fs"])
        # the int8 latent cache: codes and two f32 scales a token and layer
        self.kv_bytes = n["r"] + n["dr"] + 8

    def experts_touched(self, rows: int) -> float:
        """Experts an MoE layer's step of `rows` tokens reads: all of them
        where one goes unrouted with odds below 1e-3; else the expectation
        under uniform routing, e (1 - (1 - k/e)^rows) (64 rows: 63.88 of
        64)."""
        miss = (1 - self.k / self.e) ** rows
        if self.e * miss <= 1e-3:
            return self.e
        return self.e * (1 - miss)

    def expert_bytes(self, rows: int) -> float:
        """Routed expert weight bytes one MoE layer's step reads for `rows`
        tokens."""
        return self.wb["expert_layer"] * self.experts_touched(rows) / self.e

    def _weight_bytes(self, rows: int) -> float:
        wb = self.wb
        return (self.L * wb["attn_layer"] + self.ld * wb["dense_layer"]
                + self.lm * (wb["moe_layer"] + self.expert_bytes(rows)))

    def _token_flops(self) -> float:
        """Linear FLOPs of one token through every layer and the head."""
        return 2.0 * (self.L * self.attn_params + self.ld * self.dense_params
                      + self.lm * self.moe_params + self.d * self.v)

    def mla_decode_flops(self, contexts: list) -> float:
        """The absorbed attention's FLOPs over every layer for rows whose
        cache holds `contexts` keys before the step: a key costs each head
        (r + dr) x 2 for its score and r x 2 for its value."""
        n = self.n
        live = sum(contexts) + len(contexts)
        return 2.0 * self.L * n["h"] * (2 * n["r"] + n["dr"]) * live

    def mla_decode_bytes(self, contexts: list) -> float:
        """Bytes of the MLA decode kernel over every layer: each row's live
        latent codes and scales (its context and its new token), its
        absorbed bf16 queries and bf16 outputs."""
        n = self.n
        rows = len(contexts)
        per_layer = (self.kv_bytes * (sum(contexts) + rows)
                     + rows * n["h"] * (2 * (n["r"] + n["dr"]) + 2 * n["r"]))
        return self.L * per_layer

    def decode(self, contexts: list) -> tuple[float, float]:
        """(FLOPs, bytes) of one decode step of the whole model, head
        included, for rows whose cache holds `contexts` keys before the
        step (each attends its context and its new token)."""
        rows = len(contexts)
        flops = rows * self._token_flops() + self.mla_decode_flops(contexts)
        nbytes = (self._weight_bytes(rows) + self.wb["lm_head"]
                  + self.wb["norm"] + rows * self.wb["embed_row"]
                  + self.L * self.kv_bytes * (sum(contexts) + rows))
        return flops, nbytes

    def mla_prefill_flops(self, chunks: list) -> float:
        """The decompressed attention's FLOPs (QK^T over q/k of dn + dr and
        PV over v of dv, every head and layer) over the causal (query, key)
        pairs of valid tokens of `chunks`, each (start, n)."""
        n = self.n
        pairs = sum(m * s + m * (m + 1) // 2 for s, m in chunks)
        return (2.0 * self.L * pairs * n["h"]
                * (n["dn"] + n["dr"] + n["dv"]))

    def prefill(self, chunks: list) -> tuple[float, float]:
        """(FLOPs, bytes) of a prefill over `chunks`, each (start, n): n
        valid tokens after `start` cached ones; the head on each chunk's
        last token."""
        tokens = sum(m for _, m in chunks)
        flops = (tokens * (self._token_flops() - 2.0 * self.d * self.v)
                 + 2.0 * len(chunks) * self.d * self.v
                 + self.mla_prefill_flops(chunks))
        nbytes = (self._weight_bytes(tokens) + self.wb["lm_head"]
                  + tokens * self.wb["embed_row"]
                  + self.L * self.kv_bytes * sum(s + m for s, m in chunks))
        return flops, nbytes


def _dequant(w: dict, name: str, idx: tuple, int4: bool) -> torch.Tensor:
    """One int8 matrix in f32; the control's int4 in groups of 128 input
    rows, or of 64 where 128 does not divide them."""
    q, s = w[name + ".q"][idx], w[name + ".s"][idx]
    if not int4 or q.shape[-2] % INT4_GROUP == 0:
        return dequant(q, s, int4)
    x = q.float() * s.float()
    k, m = x.shape
    g = x.reshape(k // INT4_GROUP_SMALL, INT4_GROUP_SMALL, m)
    scale = g.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 7.0
    return (torch.round(g / scale).clamp_(-8, 7) * scale).reshape(k, m)


def _yarn_inv_freq(config: dict) -> torch.Tensor:
    """YaRN's inverse frequencies (`DeepseekV2YarnRotaryEmbedding`)."""
    dim, base = config["qk_rope_head_dim"], float(config["rope_theta"])
    rs = config["rope_scaling"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (rs["factor"] * base ** exps)

    def corr(rot):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rot * 2 * math.pi))) / (2 * math.log(base))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def _rope(t: torch.Tensor, config: dict) -> torch.Tensor:
    """(T, H, dr) de-interleaved, then rotated by positions 0..T-1."""
    n, h, dim = t.shape
    rs = config["rope_scaling"]
    inv = _yarn_inv_freq(config).to(t.device)
    ang = torch.arange(n, dtype=torch.float32, device=t.device)[:, None] * inv
    m = _mscale(rs["factor"], rs["mscale"]) / \
        _mscale(rs["factor"], rs["mscale_all_dim"])
    cos = (torch.cos(ang) * m)[:, None, :]
    sin = (torch.sin(ang) * m)[:, None, :]
    t = t.reshape(n, h, dim // 2, 2).transpose(-1, -2).reshape(n, h, dim)
    a, b = t[..., :dim // 2], t[..., dim // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(x, mats, kv_ln, config, mm):
    n = _dims(config)
    t = x.shape[0]
    h, dn, dr, dv, r = n["h"], n["dn"], n["dr"], n["dv"], n["r"]
    q = mm(x, mats["wq"]).reshape(t, h, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    c, k_pe = mm(x, mats["wkv_a"]).split([r, dr], dim=-1)
    c = rms(c, kv_ln, config["rms_norm_eps"])
    c = kv_int8(c[:, None, :])[:, 0]
    q_pe = _rope(q_pe, config)
    k_pe = kv_int8(_rope(k_pe[:, None, :], config))
    k_nope, v = mm(c, mats["wkv_b"]).reshape(t, h, dn + dv).split([dn, dv],
                                                                  dim=-1)
    k = torch.cat([k_nope, k_pe.expand(t, h, dr)], dim=-1).transpose(0, 1)
    q = torch.cat([q_nope, q_pe], dim=-1).transpose(0, 1)
    scale = (dn + dr) ** -0.5 * _mscale(
        config["rope_scaling"]["factor"],
        config["rope_scaling"]["mscale_all_dim"]) ** 2
    scores = q @ k.transpose(1, 2) * scale
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v.transpose(0, 1)   # (H, T, dv)
    return mm(out.transpose(0, 1).reshape(t, h * dv), mats["wo"])


def _swiglu(x, gate_up, down, mm):
    gate, up = mm(x, gate_up).chunk(2, dim=-1)
    return mm(torch.nn.functional.silu(gate) * up, down)


def _moe(x, w, layer, config, int4, mm):
    """The routed experts (each dequantized in turn) plus the shared
    SwiGLU, for MoE layer `layer` (counted from the first MoE layer)."""
    n = _dims(config)
    probs = torch.softmax(mm(x, w["moe_gate"][layer].float()), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[:, :n["k"]], idx[:, :n["k"]]
    if config["norm_topk_prob"]:
        top = top / top.sum(dim=-1, keepdim=True)
    else:
        top = top * config["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(n["e"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        w1, w3, w2 = (_dequant(w, nm, (layer, e), int4)
                      for nm in ("moe_w1", "moe_w3", "moe_w2"))
        xe = x[rows]
        y = mm(torch.nn.functional.silu(mm(xe, w1)) * mm(xe, w3), w2)
        out.index_add_(0, rows, y * top[rows, slot][:, None])
    shared = _swiglu(x, _dequant(w, "shared_w_gate_up", (layer,), int4),
                     _dequant(w, "shared_w_down", (layer,), int4), mm)
    return out + shared


@torch.no_grad()
def logits(w: dict, config: dict, seqs: list, positions: list,
           int4: bool = False, bf16: bool = False) -> list:
    """For each token sequence `seqs[i]` (a list of ids), the float32 logits
    (len(positions[i]), V) at `positions[i]`: the prediction of the token
    after each of those positions. Layer by layer over all sequences, so
    each layer's weights are made float32 once; the FFN runs over every
    sequence's tokens at once."""
    f32_matmuls()
    mm = mm_bf16 if bf16 else torch.matmul
    n = _dims(config)
    dev = w["embed"].device
    eps = config["rms_norm_eps"]
    xs = [w["embed"][torch.as_tensor(s, device=dev)].float() for s in seqs]
    sizes = [x.shape[0] for x in xs]
    for layer in range(n["L"]):
        mats = {nm: _dequant(w, nm, (layer,), int4)
                for nm in ("wq", "wkv_a", "wkv_b", "wo")}
        xs = [x + _attention(rms(x, w["ln1"][layer], eps), mats,
                             w["kv_ln"][layer], config, mm) for x in xs]
        del mats
        x = torch.cat(xs)
        h = rms(x, w["ln2"][layer], eps)
        if layer < n["ld"]:
            x = x + _swiglu(h, _dequant(w, "w_gate_up", (layer,), int4),
                            _dequant(w, "w_down", (layer,), int4), mm)
        else:
            x = x + _moe(h, w, layer - n["ld"], config, int4, mm)
        xs = list(x.split(sizes))
    head = dequant(w["lm_head.q"], w["lm_head.s"], int4)
    out = []
    for x, pos in zip(xs, positions):
        idx = torch.as_tensor(pos, device=dev)
        out.append(mm(rms(x[idx], w["norm"], eps), head))
    return out
