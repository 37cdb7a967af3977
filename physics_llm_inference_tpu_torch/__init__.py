"""PyTorch + CUDA port of physics_llm_inference_tpu for NVIDIA Hopper (H100).

The JAX package `physics_llm_inference_tpu` is the reference: every module
here keeps its counterpart's relative path and is tested against it on the
same inputs. This package imports torch and numpy and never jax.

Every Pallas kernel of the JAX package has a hand-written CUDA counterpart
under `csrc/`, beside a plain torch version in its module:

- kernels/int8_matmul.py        W8A16 GEMM (K1)
- kernels/int8_kv_attention.py  one-query GQA attention over the INT8 cache (K2)
- kernels/lmhead.py             fused RMSNorm + INT8 head + greedy argmax (K3)
- kernels/fused_decode.py       whole-model decode step, slot cache (K4) and
                                paged pools (K8)
- kernels/flash_attention.py    causal GQA flash attention (K5)
- kernels/paged_attention.py    paged decode attention, INT8 (K6) and bf16 (K7)
- kernels/matmul.py             tiled GEMM, bf16 and f32 (K9)
- kernels/membench.py           stream (K10) and strided (K11) row-block copies
- kernels/hello_pallas.py       elementwise add (K12)
"""
