"""A plain float32 forward of DeepSeek-V2 (arXiv:2405.04434; the model's
modeling_deepseek.py) in plain torch, for tests: no cache, no batching, no
kernels, and nothing imported but torch.

Weights are the benchmark's (benchmark/arch/deepseek_v2.weights): int8
codes `<name>.q` times f32 per-output-channel scales `<name>.s`, exact in
float32. Multi-head latent attention without q-LoRA; the rope halves of
queries and keys de-interleaved, then rotate-half RoPE on YaRN's
frequencies (mscale / mscale_all_dim on cos and sin, mscale_all_dim's
mscale squared on the softmax scale); the latent after its RMSNorm and
the rotated rope key through the int8 cache format (per token, absmax /
127, rounded half to even), as the program's latent cache holds them; the
first `first_k_dense_replace` layers a dense SwiGLU, the others an f32
gate, softmax, greedy top-k (renormalised only with `norm_topk_prob`,
else times `routed_scaling_factor`) over SwiGLU experts, plus the shared
experts' SwiGLU. TF32 is off.
"""
from __future__ import annotations

import math

import torch


def _w(w, name, *idx):
    return w[name + ".q"][idx].float() * w[name + ".s"][idx].float()


def _rms(x, weight, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * \
        weight.float()


def _int8(t):
    """(T, ..., n) through the int8 cache format over the last axis."""
    scale = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(t / scale).clamp_(-127, 127) * scale


def _mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(config):
    """DeepseekV2YarnRotaryEmbedding's inverse frequencies."""
    dim, base = config["qk_rope_head_dim"], float(config["rope_theta"])
    rs = config["rope_scaling"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / base ** exps
    freq_inter = 1.0 / (rs["factor"] * base ** exps)

    def correction_dim(rotations):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rotations * 2 * math.pi))) / \
            (2 * math.log(base))
    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    inv_freq_mask = 1.0 - ramp
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def rope(t, config):
    """t (T, H, dr) at positions 0..T-1: de-interleaved, then rotated."""
    n, h, dim = t.shape
    rs = config["rope_scaling"]
    ang = torch.arange(n, dtype=torch.float32)[:, None] * \
        yarn_inv_freq(config)
    m = _mscale(rs["factor"], rs["mscale"]) / \
        _mscale(rs["factor"], rs["mscale_all_dim"])
    cos = (torch.cos(ang) * m)[:, None, :]
    sin = (torch.sin(ang) * m)[:, None, :]
    t = t.reshape(n, h, dim // 2, 2).transpose(-1, -2).reshape(n, h, dim)
    a, b = t[..., :dim // 2], t[..., dim // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(x, w, layer, c):
    t = x.shape[0]
    h, dn, dr = (c["num_attention_heads"], c["qk_nope_head_dim"],
                 c["qk_rope_head_dim"])
    dv, r = c["v_head_dim"], c["kv_lora_rank"]
    q = (x @ _w(w, "wq", layer)).reshape(t, h, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    lat, k_pe = (x @ _w(w, "wkv_a", layer)).split([r, dr], dim=-1)
    lat = _int8(_rms(lat, w["kv_ln"][layer], c["rms_norm_eps"])[:, None, :]
                )[:, 0]
    q_pe = rope(q_pe, c)
    k_pe = _int8(rope(k_pe[:, None, :], c))
    kv = (lat @ _w(w, "wkv_b", layer)).reshape(t, h, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(t, h, dr)], dim=-1).transpose(0, 1)
    q = torch.cat([q_nope, q_pe], dim=-1).transpose(0, 1)
    scale = (dn + dr) ** -0.5 * _mscale(
        c["rope_scaling"]["factor"], c["rope_scaling"]["mscale_all_dim"]) ** 2
    scores = q @ k.transpose(1, 2) * scale
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v.transpose(0, 1)
    return out.transpose(0, 1).reshape(t, h * dv) @ _w(w, "wo", layer)


def _swiglu(x, gate_up, down):
    gate, up = (x @ gate_up).chunk(2, dim=-1)
    return (torch.nn.functional.silu(gate) * up) @ down


def _moe(x, w, layer, c):
    k = c["num_experts_per_tok"]
    probs = torch.softmax(x @ w["moe_gate"][layer].float(), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    if c["norm_topk_prob"]:
        top = top / top.sum(dim=-1, keepdim=True)
    else:
        top = top * c["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(c["n_routed_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        y = (torch.nn.functional.silu(xe @ _w(w, "moe_w1", layer, e))
             * (xe @ _w(w, "moe_w3", layer, e))) @ _w(w, "moe_w2", layer, e)
        out.index_add_(0, rows, y * top[rows, slot][:, None])
    return out + _swiglu(x, _w(w, "shared_w_gate_up", layer),
                         _w(w, "shared_w_down", layer))


@torch.no_grad()
def logits(w: dict, config: dict, seqs: list, positions: list) -> list:
    """For each sequence `seqs[i]` (token ids), the float32 logits at
    `positions[i]` (the prediction of the token after each)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = config
    eps = c["rms_norm_eps"]
    dense = c["first_k_dense_replace"]
    xs = [w["embed"][torch.as_tensor(s)].float() for s in seqs]
    sizes = [x.shape[0] for x in xs]
    for layer in range(c["num_hidden_layers"]):
        xs = [x + _attention(_rms(x, w["ln1"][layer], eps), w, layer, c)
              for x in xs]
        x = torch.cat(xs)
        h = _rms(x, w["ln2"][layer], eps)
        if layer < dense:
            x = x + _swiglu(h, _w(w, "w_gate_up", layer),
                            _w(w, "w_down", layer))
        else:
            x = x + _moe(h, w, layer - dense, c)
        xs = list(x.split(sizes))
    head = w["lm_head.q"].float() * w["lm_head.s"].float()
    return [_rms(x[torch.as_tensor(p)], w["norm"], eps) @ head
            for x, p in zip(xs, positions)]
