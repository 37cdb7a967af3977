"""Model configurations, mirrored from physics_llm_inference_tpu/models/config.py.

The JAX package's `models/__init__.py` imports jax, so the dataclass is
mirrored here field for field (same names, same defaults) rather than
imported, and so are `MoEConfig` and the named configurations.
`torch_dtype` maps the config's dtype string to a torch dtype.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_dim: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    intermediate_dim: int
    norm_eps: float = 1e-6
    use_rope: bool = True
    rope_theta: float = 10000.0
    max_seq_len: int = 4096
    dtype: str = "bfloat16"
    # "dense" (grouped SDPA in plain torch), "flash" (K5 flash_attention on
    # CUDA, its plain version on the CPU), or "auto" (flash where the JAX
    # package would pick it, dense otherwise).
    attention_impl: str = "auto"
    decode_unroll: bool = True
    # Whole-model decode kernel (kernels/fused_decode.py) for the decode
    # steps that pass the JAX package's gate. Set False for the per-op
    # decode path (int8_matmul + int8_kv_attention + lmhead).
    fused_decode: bool = True
    # Activation quantization inside the fused decode kernel: "none" keeps
    # bf16 activations (W8A16, or W4A16 with INT4 weights); "int8" quantizes
    # each activation row (W8A8, INT8 weights only).
    act_quant: str = "none"
    # MoE: num_experts > 0 replaces every block's dense SwiGLU with a routed
    # mixture (models/moe.py); intermediate_dim is the per-expert FFN width
    num_experts: int = 0
    num_experts_per_tok: int = 2
    expert_capacity_factor: float = 1.25
    tp_axis: str | None = None
    tp_data_axis: str | None = None
    head_dim_override: int | None = None

    def __post_init__(self):
        if self.head_dim_override is None and self.hidden_dim % self.num_heads:
            raise ValueError("hidden_dim must be divisible by num_heads")
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_dim // self.num_heads

    def param_count(self) -> int:
        """Analytic parameter count (embed + blocks + norm + lm_head)."""
        d, f, v = self.hidden_dim, self.intermediate_dim, self.vocab_size
        hd = self.head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        mlp = d * 2 * f + f * d
        norms = 2 * d
        per_layer = attn + mlp + norms
        return v * d + self.num_layers * per_layer + d + d * v


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (JAX `config.py:95-103`)."""
    num_experts: int = 8
    num_experts_per_tok: int = 2
    # static dispatch capacity per expert, as a multiple of the average load
    # (tokens * top_k / num_experts)
    capacity_factor: float = 1.25


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """The activation dtype named by `cfg.dtype` ("bfloat16", "float32", ...)."""
    return getattr(torch, cfg.dtype)


TOY_CONFIG = ModelConfig(
    vocab_size=1000,
    hidden_dim=512,
    num_layers=4,
    num_heads=8,
    num_kv_heads=8,
    intermediate_dim=1024,
    max_seq_len=512,
    dtype="float32",
)

LLAMA_7B_CONFIG = ModelConfig(
    vocab_size=32000,
    hidden_dim=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    intermediate_dim=11008,
)

QWEN3_CONFIG = ModelConfig(
    vocab_size=151936,
    hidden_dim=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    intermediate_dim=11008,
)

# Mixtral-style MoE dims (JAX `config.py:139-146`)
MIXTRAL_MOE_CONFIG = ModelConfig(
    vocab_size=32000,
    hidden_dim=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    intermediate_dim=14336,
)
