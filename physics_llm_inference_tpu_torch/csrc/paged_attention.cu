// K6 and K7: one-query GQA decode attention over paged KV pools.
//
// K6 replaces the TPU kernel physics_llm_inference_tpu/kernels/
// paged_attention.py (int8_paged_decode_attention -> _int8_paged_kernel):
// the merged INT8 pools, values (NB, 2, BS, Hkv*d) int8 with each block's K
// page at index 0 and its V page at index 1, scales (NB, 2, Hkv, BS) f32.
// Numerics of the TPU kernel: bf16 q times the bare int8 keys with f32
// sums, the score times k_scale / sqrt(d), an f32 online softmax, p *
// v_scale rounded to bf16 before P@V, the output divided by l where l > 0.
// The loop is kv_attn::attend (int8_kv_attention.cuh) with the paged
// addressor, the one K2, K4 and K8 run.
//
// K7 replaces paged_decode_attention -> _paged_kernel of the same file: the
// plain pools (NB, BS, Hkv, d) in bf16, everything in f32, p not rounded.
// It stages bf16 rows, so it has its own small loop here.
//
// Bound on the H100: the live KV bytes, each read once. One block per (kv
// head, request) walks [0, context_lens[b]) through the request's row of
// the block table (read with __ldg: the host writes it, no launch does), so
// dead blocks are never read, and a tile of keys may span several blocks.
// The TPU kernel's sequential grid over table columns, with its clamped
// index map, becomes the loop over the request's keys. A context past the
// table (MB * BS) is cut there and a table column is clamped to MB - 1, as
// JAX clamps its gathers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_kv_attention.cuh"

namespace {

using kv_attn::DMAX;
using kv_attn::GMAX;
using kv_attn::THREADS;

__global__ void __launch_bounds__(THREADS)
int8_paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                            const int8_t* __restrict__ kv,
                            const float* __restrict__ kvs,
                            const int* __restrict__ tables,
                            const int* __restrict__ lens,
                            __nv_bfloat16* __restrict__ out, int MB, int BS,
                            int Hq, int Hkv, int d, float scale) {
  __shared__ kv_attn::Smem sm;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int group = Hq / Hkv;
  const size_t row = (size_t)Hkv * d;
  const size_t qrow = ((size_t)b * Hq + (size_t)h * group) * d;
  const kv_attn::PagedAddr addr{kv + (size_t)h * d, kvs + (size_t)h * BS,
                                tables + (size_t)b * MB, BS, MB, row,
                                (size_t)BS * row, (size_t)Hkv * BS};
  const int ctx = min(lens[b], MB * BS);
  float acc[GMAX];
  kv_attn::attend<true>(q + qrow, addr, 0, ctx - 1, group, d, scale, sm, acc);
  if (tid < d) {
#pragma unroll
    for (int r = 0; r < GMAX; ++r) {
      if (r < group) {
        const float l = sm.l[r];
        out[qrow + (size_t)r * d + tid] = __float2bfloat16(acc[r] / (l > 0.f ? l : 1.f));
      }
    }
  }
}

constexpr int TILE7 = 64;        // keys per tile
constexpr int LD7 = DMAX + 8;    // smem row stride (bf16): conflict-free 16B reads

struct __align__(16) Smem7 {
  __nv_bfloat16 k[TILE7 * LD7];
  __nv_bfloat16 v[TILE7 * LD7];
  float q[GMAX][DMAX];
  float p[GMAX][TILE7];
  float m[GMAX], l[GMAX], alpha[GMAX];
};

__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ kp,
                       const __nv_bfloat16* __restrict__ vp,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens,
                       __nv_bfloat16* __restrict__ out, int MB, int BS, int Hq,
                       int Hkv, int d, float scale) {
  __shared__ Smem7 sm;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = Hq / Hkv;
  const size_t qrow = ((size_t)b * Hq + (size_t)h * group) * d;
  const int* table = tables + (size_t)b * MB;
  const int ctx = min(lens[b], MB * BS);

  for (int i = tid; i < group * d; i += THREADS)
    sm.q[i / d][i % d] = __bfloat162float(q[qrow + i]);
  if (tid < GMAX) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
  }
  float acc[GMAX];
#pragma unroll
  for (int r = 0; r < GMAX; ++r) acc[r] = 0.f;
  __syncthreads();

  const int cpk = d / 8;                          // 16-byte chunks per key
  for (int j0 = 0; j0 < ctx; j0 += TILE7) {
    const int n = min(TILE7, ctx - j0);
    for (int c = tid; c < n * cpk; c += THREADS) {
      const int key = c / cpk, part = c % cpk, j = j0 + key;
      const size_t blk = (size_t)__ldg(table + min(j / BS, MB - 1));
      const size_t off = ((blk * BS + j % BS) * Hkv + h) * d + part * 8;
      *reinterpret_cast<uint4*>(&sm.k[key * LD7 + part * 8]) =
          *reinterpret_cast<const uint4*>(kp + off);
      *reinterpret_cast<uint4*>(&sm.v[key * LD7 + part * 8]) =
          *reinterpret_cast<const uint4*>(vp + off);
    }
    __syncthreads();

    // scores: one thread per key
    if (tid < n) {
      float dot[GMAX];
#pragma unroll
      for (int r = 0; r < GMAX; ++r) dot[r] = 0.f;
      for (int c0 = 0; c0 < d; c0 += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(&sm.k[tid * LD7 + c0]);
        const __nv_bfloat16* kk = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float kf = __bfloat162float(kk[e]);
#pragma unroll
          for (int r = 0; r < GMAX; ++r)
            if (r < group) dot[r] += sm.q[r][c0 + e] * kf;
        }
      }
#pragma unroll
      for (int r = 0; r < GMAX; ++r)
        if (r < group) sm.p[r][tid] = dot[r] * scale;
    }
    __syncthreads();

    // online softmax: one warp per query row, all in f32
    for (int r = warp; r < group; r += THREADS / 32) {
      float mt = -INFINITY;
      for (int t = lane; t < n; t += 32) mt = fmaxf(mt, sm.p[r][t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(sm.p[r][t] - m_new);
        sum += p;
        sm.p[r][t] = p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);   // 0 on the first tile
        sm.alpha[r] = alpha;
        sm.l[r] = sm.l[r] * alpha + sum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

    // P @ V: one thread per output dimension
    if (tid < d) {
#pragma unroll
      for (int r = 0; r < GMAX; ++r)
        if (r < group) acc[r] *= sm.alpha[r];
      for (int t = 0; t < n; ++t) {
        const float vf = __bfloat162float(sm.v[t * LD7 + tid]);
#pragma unroll
        for (int r = 0; r < GMAX; ++r)
          if (r < group) acc[r] += sm.p[r][t] * vf;
      }
    }
    __syncthreads();
  }

  if (tid < d) {
#pragma unroll
    for (int r = 0; r < GMAX; ++r) {
      if (r < group) {
        const float l = sm.l[r];
        out[qrow + (size_t)r * d + tid] = __float2bfloat16(acc[r] / (l > 0.f ? l : 1.f));
      }
    }
  }
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
  paged_attention_kernel<<<dim3(Hkv, B), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), MB, BS,
      Hq, Hkv, d, scale);
  return static_cast<int>(cudaGetLastError());
}
