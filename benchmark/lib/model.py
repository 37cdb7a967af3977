"""A configuration file as the port's ModelConfig, and its weights made
from the seed on the device.

The weights are the benchmark's: int8 codes and f32 per-output-channel
scales for every block matrix and the LM head (the served format, W8A16),
embeddings, norm weights and router gates in the activation dtype, made on
the device by one `torch.Generator` in a few large calls. `weights()` returns them as plain
tensors under the benchmark's own names; `program_params()` wraps the same
tensors in the port's parameter dict, so both sides read one copy.
"""
from __future__ import annotations

import torch

# a uniform int8 code in [-127, 127] has this standard deviation
_INT8_STD = 73.9


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
    scales `<name>.s` (one per layer and output channel, std of the
    product fan_in**-0.5 times a factor in [0.75, 1.25]) for each block
    matrix and `lm_head`; `embed`, `norm`, `ln1`, `ln2` (norm weights in
    [0.8, 1.2]) and, for experts, `moe_gate` in the activation dtype."""
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    L, d, v = (config["num_hidden_layers"], config["hidden_size"],
               config["vocab_size"])
    act = getattr(torch, config["precision"]["activations"])

    def uniform(shape, lo, hi, dtype=torch.float32):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.uniform_(lo, hi, generator=g)

    def int8_matrix(lead, k, n):
        q = torch.randint(-127, 128, (*lead, k, n), dtype=torch.int8,
                          generator=g, device=device)
        s = uniform((*lead, 1, n), 0.75, 1.25).mul_(k ** -0.5 / _INT8_STD)
        return q, s

    w = {"embed": torch.randn((v, d), generator=g, device=device,
                              dtype=act).mul_(d ** -0.5),
         "norm": uniform((d,), 0.8, 1.2, act),
         "ln1": uniform((L, d), 0.8, 1.2, act),
         "ln2": uniform((L, d), 0.8, 1.2, act)}
    for name, shape in shapes(config).items():
        w[name + ".q"], w[name + ".s"] = int8_matrix((L, *shape[:-2]),
                                                     *shape[-2:])
    if config.get("num_local_experts", 0):
        w["moe_gate"] = torch.randn(
            (L, d, config["num_local_experts"]), generator=g, device=device,
            dtype=act).mul_(d ** -0.5)
    q, s = int8_matrix((), d, v)
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
    """Bytes of the weights by part: `blocks` (per layer, the expert
    stacks apart in `experts`), `lm_head`, `embed_row` (one row)."""
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
