// K2: one-query GQA decode attention over the INT8 KV cache.
//
// Replaces the TPU kernel physics_llm_inference_tpu/kernels/
// int8_kv_attention.py (int8_kv_decode_attention -> _kernel). Same contract:
// K and V are bare int8 values in the flat (B, S, Hkv*d) layout, their f32
// scales are transposed (B, Hkv, S); the k-scale multiplies the score row and
// the v-scale the probability row, so neither K nor V is dequantized element
// by element; the mask is valid_from[b] <= k <= q_slot[b]; the softmax is an
// f32 online softmax whose denominator is never zero.
//
// Bound on the H100: the live KV bytes (each int8 byte of the live cache is
// read once and feeds 2 flop per query row of its group). One block per
// (kv head, request) walks the cache only over [valid_from, q_slot] -- the
// Hopper form of the TPU kernel's clamped index map: masked tiles are never
// read at all. The loop is kv_attn::attend (int8_kv_attention.cuh), which
// K4, K6, K7 and K8 share: its four warps split the live keys, each streams
// its 16-key steps through its own cp.async ring and runs both products on
// mma.sync, so the next step's bytes are in flight while a step computes.
// p * v_scale stays f32 in value: P@V runs on its bf16 high part and the
// bf16 of its remainder. 38.4 KB of shared memory and 128 registers a
// thread: four blocks an SM, so the B 64 x Hkv 8 grid is one wave.

#include <cuda_runtime.h>

#include "int8_kv_attention.cuh"

namespace {

using kv_attn::GMAX;
using kv_attn::THREADS;

__global__ void __launch_bounds__(THREADS)
int8_kv_decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq,
    const float* __restrict__ ks, const int8_t* __restrict__ vq,
    const float* __restrict__ vs, const int* __restrict__ q_slot,
    const int* __restrict__ valid_from, __nv_bfloat16* __restrict__ out,
    int S, int Hq, int Hkv, int d, float scale) {
  __shared__ kv_attn::Smem<int8_t> sm;

  const int h = blockIdx.x, b = blockIdx.y;
  const int group = Hq / Hkv;
  const size_t row = (size_t)Hkv * d;             // bytes between keys
  const size_t qrow = ((size_t)b * Hq + (size_t)h * group) * d;

  const kv_attn::SlotAddr addr{kq + (size_t)b * S * row + (size_t)h * d,
                               vq + (size_t)b * S * row + (size_t)h * d,
                               ks + ((size_t)b * Hkv + h) * S,
                               vs + ((size_t)b * Hkv + h) * S, row};
  float acc[GMAX];
  kv_attn::attend<false>(q + qrow, addr, max(valid_from[b], 0),
                         min(q_slot[b], S - 1), group, d, scale, sm, acc);

  kv_attn::store_rows(out + qrow, acc, sm, group, d);
}

}  // namespace

// q (B, Hq, d) bf16; k_q/v_q (B, S, Hkv*d) int8; k_s/v_s (B, Hkv, S) f32;
// q_slot/valid_from (B,) int32; out (B, Hq, d) bf16. All contiguous, the
// int8 rows 16-byte aligned, d % 16 == 0, d <= 128, Hq / Hkv <= 8 (checked
// by the Python wrapper). Returns cudaGetLastError().
extern "C" int pli_int8_kv_decode_attention(
    const void* q, const void* k_q, const void* k_s, const void* v_q,
    const void* v_s, const void* q_slot, const void* valid_from, void* out,
    int B, int S, int Hq, int Hkv, int d, float scale, void* stream) {
  dim3 grid(Hkv, B);
  int8_kv_decode_attention_kernel<<<grid, THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_q),
      static_cast<const float*>(k_s), static_cast<const int8_t*>(v_q),
      static_cast<const float*>(v_s), static_cast<const int*>(q_slot),
      static_cast<const int*>(valid_from), static_cast<__nv_bfloat16*>(out), S,
      Hq, Hkv, d, scale);
  return static_cast<int>(cudaGetLastError());
}
