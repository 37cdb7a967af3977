"""Model configurations, mirrored from physics_llm_inference_tpu/models/config.py.

The JAX package's `models/__init__.py` imports jax, so the dataclass is
mirrored here field for field (same names, same defaults) rather than
imported, and so are `MoEConfig` and the named configurations.
`torch_dtype` maps the config's dtype string to a torch dtype.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class YarnScaling:
    """YaRN's `rope_scaling` (type "yarn") as DeepSeek-V2 publishes it."""
    factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707


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
    # Tensor parallelism: a per-rank TPConfig (parallel/tp.py
    # tp_local_config) names the mesh axis it shards on; head_dim_override
    # keeps the true head size when num_heads is the local count
    tp_axis: str | None = None
    tp_data_axis: str | None = None
    head_dim_override: int | None = None
    # DeepSeek-V2's settings (DeepSeekV2Config's fields) read on every
    # config: class attributes, not fields, so ModelConfig stays the JAX
    # package's field for field
    router_f32 = False
    norm_topk_prob = True
    routed_scaling_factor = 1.0
    shared_expert_dim = 0
    first_k_dense_replace = 0
    kv_lora_rank = 0

    def __post_init__(self):
        if self.head_dim_override is None and self.hidden_dim % self.num_heads:
            raise ValueError("hidden_dim must be divisible by num_heads")
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

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
class DeepSeekV2Config(ModelConfig):
    """A ModelConfig with DeepSeek-V2's parts (arXiv:2405.04434): its
    router, shared experts, leading dense layers, multi-head latent
    attention and YaRN. The JAX package has none of them."""

    # DeepSeek-V2's router (arXiv:2405.04434): the gate's product and softmax
    # in f32, and the top-k weights kept as they are (times
    # routed_scaling_factor) instead of renormalised
    router_f32: bool = False
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    # shared experts: one SwiGLU of this width (all shared experts side by
    # side) that every token of an MoE layer passes through; 0: none
    shared_expert_dim: int = 0
    # the first `first_k_dense_replace` layers of an MoE model keep a dense
    # SwiGLU of width `dense_intermediate_dim`
    first_k_dense_replace: int = 0
    dense_intermediate_dim: int = 0
    # multi-head latent attention (models/mla.py): kv_lora_rank > 0 replaces
    # GQA; queries of qk_nope_head_dim + qk_rope_head_dim, values of
    # v_head_dim, and a cache of the kv_lora_rank latent and one shared rope
    # key a token
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN frequencies and attention scale (ops/rope.py) of the rope key
    rope_yarn: YarnScaling = YarnScaling()


@dataclass(frozen=True)
class TPConfig(ModelConfig):
    """The per-rank ModelConfig of tensor parallelism (parallel/tp.py
    tp_local_config): local head and FFN counts, `tp_axis`, and the mesh
    whose group reduces over that axis. ModelConfig itself stays the JAX
    package's field for field."""

    tp_mesh: object = field(default=None, compare=False, repr=False)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (JAX `config.py:95-103`), with
    DeepSeek-V2's router options (ModelConfig's fields of the same names)."""
    num_experts: int = 8
    num_experts_per_tok: int = 2
    # static dispatch capacity per expert, as a multiple of the average load
    # (tokens * top_k / num_experts)
    capacity_factor: float = 1.25
    # DeepSeek-V2's router (DeepSeekMoEConfig's fields), as on ModelConfig
    router_f32 = False
    norm_topk_prob = True
    routed_scaling_factor = 1.0


@dataclass(frozen=True)
class DeepSeekMoEConfig(MoEConfig):
    """MoEConfig with DeepSeek-V2's router options."""
    router_f32: bool = False
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0


def moe_config(cfg: ModelConfig) -> MoEConfig:
    """The MoE settings of a model configuration (a DeepSeekMoEConfig where
    its router is DeepSeek-V2's)."""
    base = dict(num_experts=cfg.num_experts,
                num_experts_per_tok=cfg.num_experts_per_tok,
                capacity_factor=cfg.expert_capacity_factor)
    if (cfg.router_f32, cfg.norm_topk_prob, cfg.routed_scaling_factor) == \
            (False, True, 1.0):
        return MoEConfig(**base)
    return DeepSeekMoEConfig(router_f32=cfg.router_f32,
                             norm_topk_prob=cfg.norm_topk_prob,
                             routed_scaling_factor=cfg.routed_scaling_factor,
                             **base)


def refuse_mla(cfg, what: str) -> None:
    """Raise where a path does not take multi-head latent attention yet."""
    if getattr(cfg, "kv_lora_rank", 0):
        raise NotImplementedError(
            f"{what} does not take MLA (multi-head latent attention, "
            f"kv_lora_rank {cfg.kv_lora_rank}) yet: run it through "
            f"runtime/generate.cached_generate")


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

# DeepSeek-V2-Lite at its published widths (https://huggingface.co/
# deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json): MLA without q-LoRA,
# layer 0 dense, layers 1-26 of 64 routed experts (top-6, no
# renormalisation) and 2 shared ones. intermediate_dim is the routed
# expert's width, as for every MoE config here; capacity 10.67 just above
# experts / top-k, so no (token, expert) pair is dropped.
DEEPSEEK_V2_LITE_CONFIG = DeepSeekV2Config(
    vocab_size=102400,
    hidden_dim=2048,
    num_layers=27,
    num_heads=16,
    num_kv_heads=16,
    intermediate_dim=1408,
    norm_eps=1e-6,
    rope_theta=10000.0,
    max_seq_len=163840,
    num_experts=64,
    num_experts_per_tok=6,
    expert_capacity_factor=10.67,
    router_f32=True,
    norm_topk_prob=False,
    shared_expert_dim=2816,
    first_k_dense_replace=1,
    dense_intermediate_dim=10944,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
)
