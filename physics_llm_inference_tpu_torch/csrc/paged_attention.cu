// K6 and K7: one-query GQA decode attention over paged KV pools.
//
// K6 replaces the TPU kernel physics_llm_inference_tpu/kernels/
// paged_attention.py (int8_paged_decode_attention -> _int8_paged_kernel):
// the merged INT8 pools, values (NB, 2, BS, Hkv*d) int8 with each block's K
// page at index 0 and its V page at index 1, scales (NB, 2, Hkv, BS) f32.
// Numerics of the TPU kernel: bf16 q times the bare int8 keys with f32
// sums, the score times k_scale / sqrt(d), an f32 online softmax, p *
// v_scale rounded to bf16 before P@V, the output divided by l where l > 0.
//
// K7 replaces paged_decode_attention -> _paged_kernel of the same file: the
// plain pools (NB, BS, Hkv, d) in bf16, everything in f32, p not rounded
// (P@V on p's bf16 high part and the bf16 of its remainder).
//
// Bound on the H100: the live KV bytes, each read once. Both run the loop
// kv_attn::attend (int8_kv_attention.cuh) that K2, K4 and K8 run, K6 with
// the paged addressor, K7 with its bf16 one: one block per (kv head,
// request) walks [0, context_lens[b]) through the request's row of the
// block table (read with __ldg: the host writes it, no launch does), so
// dead blocks are never read; its four warps split the keys, each streams
// 16-key steps (a step may span blocks: every key row is its own 16-byte
// copies behind one table lookup) through its own cp.async ring while the
// previous step's two mma.sync products run. The TPU kernel's sequential
// grid over table columns, with its clamped index map, becomes that loop
// over the request's keys. A context past the table (MB * BS) is cut there
// and a table column is clamped to MB - 1, as JAX clamps its gathers.
// Shared memory: K6 38.3 KB a block; K7 70 KB (bf16 rows are twice as
// wide, two 16-key stages a warp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_kv_attention.cuh"

namespace {

using kv_attn::GMAX;
using kv_attn::THREADS;
using Smem7 = kv_attn::Smem<__nv_bfloat16>;

__global__ void __launch_bounds__(THREADS)
int8_paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const int8_t* __restrict__ kv,
                            const float* __restrict__ kvs,
                            const int* __restrict__ tables,
                            const int* __restrict__ lens,
                            __nv_bfloat16* __restrict__ out, int MB, int BS,
                            int Hq, int Hkv, int d, float scale) {
  __shared__ kv_attn::Smem<int8_t> sm;
  const int h = blockIdx.x, b = blockIdx.y;
  const int group = Hq / Hkv;
  const size_t row = (size_t)Hkv * d;
  const size_t qrow = ((size_t)b * Hq + (size_t)h * group) * d;
  const kv_attn::PagedAddr addr{kv + (size_t)h * d, kvs + (size_t)h * BS,
                                tables + (size_t)b * MB, BS, MB, row,
                                (size_t)BS * row, (size_t)Hkv * BS};
  const int ctx = min(lens[b], MB * BS);
  float acc[GMAX];
  kv_attn::attend<true>(q + qrow, addr, 0, ctx - 1, group, d, scale, sm, acc);
  kv_attn::store_rows(out + qrow, acc, sm, group, d);
}

__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ kp,
                       const __nv_bfloat16* __restrict__ vp,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens,
                       __nv_bfloat16* __restrict__ out, int MB, int BS, int Hq,
                       int Hkv, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem7[];
  auto& sm = *reinterpret_cast<Smem7*>(smem7);
  const int h = blockIdx.x, b = blockIdx.y;
  const int group = Hq / Hkv;
  const size_t qrow = ((size_t)b * Hq + (size_t)h * group) * d;
  const kv_attn::PagedBf16Addr addr{kp + (size_t)h * d, vp + (size_t)h * d,
                                    tables + (size_t)b * MB, BS, MB,
                                    (size_t)Hkv * d * sizeof(__nv_bfloat16)};
  const int ctx = min(lens[b], MB * BS);
  float acc[GMAX];
  kv_attn::attend<false>(q + qrow, addr, 0, ctx - 1, group, d, scale, sm, acc);
  kv_attn::store_rows(out + qrow, acc, sm, group, d);
}

}  // namespace

// K6. q (B, Hq, d) bf16; kv (NB, 2, BS, Hkv*d) int8 and kvs (NB, 2, Hkv, BS)
// f32, one layer of the merged pools; tables (B, MB) int32 with entries
// < NB; lens (B,) int32 keys to attend; out (B, Hq, d) bf16. All
// contiguous, the pool rows 16-byte aligned, d % 16 == 0, d <= 128,
// Hq / Hkv <= 8 (checked by the Python wrapper). Returns cudaGetLastError().
extern "C" int pli_int8_paged_decode_attention(
    const void* q, const void* kv, const void* kvs, const void* tables,
    const void* lens, void* out, int B, int MB, int BS, int Hq, int Hkv, int d,
    float scale, void* stream) {
  int8_paged_attention_kernel<<<dim3(Hkv, B), THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kv),
      static_cast<const float*>(kvs), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), MB, BS,
      Hq, Hkv, d, scale);
  return static_cast<int>(cudaGetLastError());
}

// K7. q (B, Hq, d) bf16; k/v (NB, BS, Hkv, d) bf16, one layer of the pools;
// tables, lens and out as K6. d % 8 == 0, d <= 128, Hq / Hkv <= 8.
extern "C" int pli_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lens, void* out, int B, int MB, int BS, int Hq, int Hkv, int d,
    float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem7)));
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_attention_kernel<<<dim3(Hkv, B), THREADS, sizeof(Smem7),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), MB, BS,
      Hq, Hkv, d, scale);
  return static_cast<int>(cudaGetLastError());
}

// K7's block for the occupancy model (specs/occupancy.py): threads, bytes
// of dynamic shared memory (K6 takes its Smem<int8_t> statically), and the
// CUDA runtime's own count of resident blocks an SM, to hold the model
// against.
extern "C" int pli_paged_decode_attention_block(int* threads, int* smem_bytes,
                                                int* blocks_per_sm) {
  *threads = THREADS;
  *smem_bytes = static_cast<int>(sizeof(Smem7));
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem7)));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, paged_attention_kernel, THREADS, sizeof(Smem7)));
}
