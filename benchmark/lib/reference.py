"""The plain reference: the published forward pass of a Mistral- or
Mixtral-shaped decoder in float32, in plain torch, over whole sequences
(no cache, no batching, no kernels). It imports nothing of the port.

It follows the configuration's stated precision where that is part of the
model's definition: block matrices and the LM head are the int8 codes
times their scales (exact in float32), and keys and values pass through
the int8 cache format (per token and KV head, absmax / 127, rounded half
to even, clipped to +-127). Activations are float32 with TF32 off.
Mistral (arXiv:2310.06825): RMSNorm, RoPE with rotate-half, grouped-query
attention, SwiGLU. Mixtral (arXiv:2401.04088): the FFN is a router over
experts, softmax, top-k, the k weights renormalised, each a SwiGLU.

`int4=True` is the control: every int8 matrix re-quantized to int4 (groups
of 128 input rows per output channel, absmax / 7, round, clip to [-8, 7]),
the precision step below int8. `bf16=True` is a witness, not a reference:
each product's inputs and output rounded to bfloat16, as a program with
bfloat16 activations rounds them (the router's logits included).
"""
from __future__ import annotations

import torch

INT4_GROUP = 128


def _f32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dequant(q: torch.Tensor, s: torch.Tensor, int4: bool) -> torch.Tensor:
    w = q.float() * s.float()
    if not int4:
        return w
    k, n = w.shape
    g = w.reshape(k // INT4_GROUP, INT4_GROUP, n)
    scale = g.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 7.0
    return (torch.round(g / scale).clamp_(-8, 7) * scale).reshape(k, n)


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with its inputs and output rounded to bfloat16 (the witness)."""
    return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).float()


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _kv_int8(t: torch.Tensor) -> torch.Tensor:
    """(T, H, hd) through the int8 cache format, per token and head."""
    scale = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(t / scale).clamp_(-127, 127) * scale


def _rope(t: torch.Tensor, theta: float) -> torch.Tensor:
    """(T, H, hd) rotated by positions 0..T-1 (rotate-half)."""
    n, _, hd = t.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=t.device) / hd)
    ang = torch.arange(n, dtype=torch.float32, device=t.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = t[..., :hd // 2], t[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(x, wqkv, wo, config, mm):
    n = x.shape[0]
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim") or config["hidden_size"] // hq
    q, k, v = mm(x, wqkv).split([hq * hd, hkv * hd, hkv * hd], dim=-1)
    q = _rope(q.reshape(n, hq, hd), config["rope_theta"])
    k = _kv_int8(_rope(k.reshape(n, hkv, hd), config["rope_theta"]))
    v = _kv_int8(v.reshape(n, hkv, hd))
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
        w1, w3, w2 = (_dequant(w[f"{n}.q"][layer, e], w[f"{n}.s"][layer, e],
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
    _f32_matmuls()
    mm = _mm_bf16 if bf16 else torch.matmul
    dev = w["embed"].device
    eps = config["rms_norm_eps"]
    xs = [w["embed"][torch.as_tensor(s, device=dev)].float() for s in seqs]
    moe = config.get("num_local_experts", 0) > 0
    for layer in range(config["num_hidden_layers"]):
        wqkv = _dequant(w["wqkv.q"][layer], w["wqkv.s"][layer], int4)
        wo = _dequant(w["wo.q"][layer], w["wo.s"][layer], int4)
        if not moe:
            gu = _dequant(w["w_gate_up.q"][layer], w["w_gate_up.s"][layer],
                          int4)
            gate, up = gu.chunk(2, dim=-1)
            down = _dequant(w["w_down.q"][layer], w["w_down.s"][layer], int4)
        for i, x in enumerate(xs):
            x = x + _attention(_rms(x, w["ln1"][layer], eps), wqkv, wo,
                               config, mm)
            h = _rms(x, w["ln2"][layer], eps)
            x = x + (_moe(h, w, layer, config, int4, mm) if moe
                     else _swiglu(h, gate, up, down, mm))
            xs[i] = x
        del wqkv, wo
        if not moe:
            del gu, gate, up, down
    head = _dequant(w["lm_head.q"], w["lm_head.s"], int4)
    out = []
    for x, pos in zip(xs, positions):
        idx = torch.as_tensor(pos, device=dev)
        out.append(mm(_rms(x[idx], w["norm"], eps), head))
    return out
