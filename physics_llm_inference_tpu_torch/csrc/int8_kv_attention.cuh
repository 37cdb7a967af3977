// The attention loop over the INT8 KV cache for one (request, kv head).
//
// Shared by int8_kv_attention.cu (K2) and fused_decode.cu (K4). One block of
// THREADS threads loads its `group` query rows once and walks the cache in
// tiles of TILE keys over [k_first, k_last] only: masked slots are never
// read. Each tile is staged into shared memory with 16-byte loads (one key
// row of one head is d contiguous bytes), scores are one thread per key,
// P@V is one thread per output dimension. K and V stay bare int8: the
// k-scale multiplies the score row and the v-scale the probability row. The
// softmax is an f32 online softmax.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace kv_attn {

constexpr int THREADS = 128;
constexpr int TILE = 128;      // keys per tile
constexpr int DMAX = 128;      // head_dim limit (d % 16 == 0)
constexpr int GMAX = 8;        // query heads per kv head limit
constexpr int KLD = DMAX + 16; // smem row stride (bytes): conflict-free 16B reads

struct __align__(16) Smem {
  int8_t k[TILE * KLD];
  int8_t v[TILE * KLD];
  float q[GMAX][DMAX];
  float p[GMAX][TILE];
  float ks[TILE];
  float vs[TILE];
  float m[GMAX], l[GMAX], alpha[GMAX];
};

// A bf16 value read through L2 (ld.global.cg): data that another block of
// the same launch wrote is never served from a stale L1 line.
static __device__ __forceinline__ float ldcg_bf16(const __nv_bfloat16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

static __device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// q: the group's `group` query rows (group * d bf16, contiguous). kbase/vbase
// point at slot 0 of this head's cache row, `row` bytes between slots;
// ksb/vsb at slot 0 of this head's scales. On return (all threads past a
// __syncthreads) sm.q holds the query rows in f32, sm.m / sm.l each row's
// running max and denominator (m = -inf, l = 0 when no slot is live), and
// acc[r] of thread tid < d the unnormalised output of row r, dimension tid.
// kRoundP rounds p * v_scale to bf16 before P@V (the fused kernel's
// numerics); otherwise it stays f32.
template <bool kRoundP>
static __device__ void attend_cache(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kbase,
    const int8_t* __restrict__ vbase, const float* __restrict__ ksb,
    const float* __restrict__ vsb, size_t row, int k_first, int k_last,
    int group, int d, float scale, Smem& sm, float (&acc)[GMAX]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < group * d; i += THREADS) sm.q[i / d][i % d] = ldcg_bf16(q + i);
  if (tid < GMAX) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < GMAX; ++r) acc[r] = 0.f;
  __syncthreads();

  const int cpk = d / 16;                          // 16-byte chunks per key
  for (int j0 = k_first; j0 <= k_last; j0 += TILE) {
    const int n = min(TILE, k_last - j0 + 1);
    for (int c = tid; c < n * cpk; c += THREADS) {
      const int key = c / cpk, part = c % cpk;
      const size_t off = (size_t)(j0 + key) * row + part * 16;
      *reinterpret_cast<uint4*>(&sm.k[key * KLD + part * 16]) =
          *reinterpret_cast<const uint4*>(kbase + off);
      *reinterpret_cast<uint4*>(&sm.v[key * KLD + part * 16]) =
          *reinterpret_cast<const uint4*>(vbase + off);
    }
    for (int t = tid; t < n; t += THREADS) {
      sm.ks[t] = ksb[j0 + t];
      sm.vs[t] = vsb[j0 + t];
    }
    __syncthreads();

    // scores: one thread per key, the k-scale lands on the score
    if (tid < n) {
      float dot[GMAX];
#pragma unroll
      for (int r = 0; r < GMAX; ++r) dot[r] = 0.f;
      for (int c0 = 0; c0 < d; c0 += 16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(&sm.k[tid * KLD + c0]);
        const int8_t* kv = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float kf = static_cast<float>(kv[e]);
#pragma unroll
          for (int r = 0; r < GMAX; ++r)
            if (r < group) dot[r] += sm.q[r][c0 + e] * kf;
        }
      }
      const float sk = sm.ks[tid] * scale;
#pragma unroll
      for (int r = 0; r < GMAX; ++r)
        if (r < group) sm.p[r][tid] = dot[r] * sk;
    }
    __syncthreads();

    // online softmax: one warp per query row; p is scaled by the v-scale
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
        const float pv = p * sm.vs[t];
        sm.p[r][t] = kRoundP ? round_bf16(pv) : pv;
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
        const float vf = static_cast<float>(sm.v[t * KLD + tid]);
#pragma unroll
        for (int r = 0; r < GMAX; ++r)
          if (r < group) acc[r] += sm.p[r][t] * vf;
      }
    }
    __syncthreads();
  }
}

}  // namespace kv_attn
