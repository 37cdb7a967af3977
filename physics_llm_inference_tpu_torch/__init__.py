"""PyTorch + CUDA port of physics_llm_inference_tpu for NVIDIA Hopper (H100).

The JAX package `physics_llm_inference_tpu` is the reference: every module
here keeps its counterpart's relative path and is tested against it on the
same inputs. This package imports torch and numpy and never jax.

Slice ported so far: the INT8 W+KV cached-generation path with the per-op
decode configuration (`ModelConfig.fused_decode=False`), whose three TPU
kernels have hand-written CUDA counterparts under `csrc/`:

- kernels/int8_matmul.py        W8A16 GEMM (K1)
- kernels/int8_kv_attention.py  one-query GQA attention over the INT8 cache (K2)
- kernels/lmhead.py             fused RMSNorm + INT8 head + greedy argmax (K3)
"""
