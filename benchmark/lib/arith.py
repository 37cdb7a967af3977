"""The yardstick's arithmetic: percentiles, the card's peaks, and each
kernel's and step's operations and bytes from shapes and from the inputs
actually used (the live KV, the valid tokens, the experts routed to).
Nothing counts what a kernel happens to read again or pad.
"""
from __future__ import annotations

import json
from pathlib import Path

_PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"


def percentile(values: list, p: float) -> float:
    """The value at the rounded index p/100 x (n - 1) of the sorted values
    (the repository's bench/harness.py rule)."""
    if not values:
        return float("nan")
    vs = sorted(values)
    return vs[min(len(vs) - 1, int(round((p / 100) * (len(vs) - 1))))]


def peaks(device_name: str) -> dict | None:
    """The published peaks of a card by its torch name, or None."""
    with open(_PEAKS) as f:
        return json.load(f)["cards"].get(device_name)


class Work:
    """Operations and compulsory bytes of a model's steps."""

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


def ideal_s(flops: float, nbytes: float, pk: dict) -> tuple[float, str]:
    """The least time of (FLOPs, bytes) on the card, and which bound."""
    tf, tb = flops / pk["bf16_flops"], nbytes / pk["hbm_bytes_s"]
    return (tf, "flops") if tf >= tb else (tb, "bytes")
