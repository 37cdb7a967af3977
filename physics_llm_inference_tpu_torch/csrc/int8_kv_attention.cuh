// The attention loop over an INT8 KV cache for one (request, kv head).
//
// Shared by int8_kv_attention.cu (K2), fused_decode.cu (K4 and K8) and
// paged_attention.cu (K6). One block of THREADS threads loads its `group`
// query rows once and walks the live keys [k_first, k_last] in tiles of TILE
// keys: masked keys are never read. Where key j lives is the addressor's
// business: SlotAddr for a slot cache row (K2, K4), PagedAddr for a block
// pool reached through a block table (K6, K8), so a tile may span several
// blocks. Each tile is staged into shared memory with 16-byte loads (one key
// row of one head is d contiguous bytes), scores are one thread per key, P@V
// is one thread per output dimension. K and V stay bare int8: the k-scale
// multiplies the score row and the v-scale the probability row. The softmax
// is an f32 online softmax.
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

// Key j of a slot cache row: kbase/vbase point at slot 0 of this head's
// cache row, `row` bytes between slots; ksb/vsb at slot 0 of its scales.
struct SlotAddr {
  const int8_t* kbase;
  const int8_t* vbase;
  const float* ksb;
  const float* vsb;
  size_t row;
  __device__ __forceinline__ const int8_t* k(int j) const { return kbase + (size_t)j * row; }
  __device__ __forceinline__ const int8_t* v(int j) const { return vbase + (size_t)j * row; }
  __device__ __forceinline__ float ks(int j) const { return ksb[j]; }
  __device__ __forceinline__ float vs(int j) const { return vsb[j]; }
};

// Key j of one request in the merged paged pools of one layer: values
// (NB, 2, BS, Hkv*d) int8 with K at page 0 and V at page 1 of each block,
// scales (NB, 2, Hkv, BS) f32. kv points at block 0, page 0, position 0,
// column g*d of this head; kvs at block 0, page 0, head g, position 0.
// table is the request's row of the block table (MB entries, written by
// the host and only read here, hence __ldg); the column is clamped to MB-1
// as JAX clamps an out-of-range gather.
struct PagedAddr {
  const int8_t* kv;
  const float* kvs;
  const int* table;
  int bs, mb;
  size_t row;        // bytes between positions of a page (Hkv * d)
  size_t page;       // bytes of one page (BS * row)
  size_t spage;      // floats of one scale page (Hkv * BS)
  __device__ __forceinline__ size_t blk(int j) const {
    return (size_t)__ldg(table + min(j / bs, mb - 1));
  }
  __device__ __forceinline__ const int8_t* k(int j) const {
    return kv + blk(j) * 2 * page + (size_t)(j % bs) * row;
  }
  __device__ __forceinline__ const int8_t* v(int j) const {
    return kv + (blk(j) * 2 + 1) * page + (size_t)(j % bs) * row;
  }
  __device__ __forceinline__ float ks(int j) const {
    return kvs[blk(j) * 2 * spage + j % bs];
  }
  __device__ __forceinline__ float vs(int j) const {
    return kvs[(blk(j) * 2 + 1) * spage + j % bs];
  }
};

// q: the group's `group` query rows (group * d bf16, contiguous); `a` the
// addressor of this (request, kv head)'s keys. On return (all threads past a
// __syncthreads) sm.q holds the query rows in f32, sm.m / sm.l each row's
// running max and denominator (m = -inf, l = 0 when no slot is live), and
// acc[r] of thread tid < d the unnormalised output of row r, dimension tid.
// kRoundP rounds p * v_scale to bf16 before P@V (the fused kernel's
// numerics); otherwise it stays f32.
template <bool kRoundP, class Addr>
static __device__ void attend(const __nv_bfloat16* __restrict__ q, const Addr& a,
                              int k_first, int k_last, int group, int d,
                              float scale, Smem& sm, float (&acc)[GMAX]) {
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
      *reinterpret_cast<uint4*>(&sm.k[key * KLD + part * 16]) =
          *reinterpret_cast<const uint4*>(a.k(j0 + key) + part * 16);
      *reinterpret_cast<uint4*>(&sm.v[key * KLD + part * 16]) =
          *reinterpret_cast<const uint4*>(a.v(j0 + key) + part * 16);
    }
    for (int t = tid; t < n; t += THREADS) {
      sm.ks[t] = a.ks(j0 + t);
      sm.vs[t] = a.vs(j0 + t);
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
