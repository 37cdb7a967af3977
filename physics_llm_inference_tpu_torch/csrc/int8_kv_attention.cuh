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

// Byte j of the int8 word w, as an exact f32: the byte, xored with 0x80
// (w ^ 0x80808080), under the exponent of 2^23, less 2^23 + 128.
static __device__ __forceinline__ float byte_f32(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 | j)) - 8388736.f;
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
  // key j's K and V rows, and its two scales
  __device__ __forceinline__ void rows(int j, const int8_t*& k, const int8_t*& v) const {
    k = kbase + (size_t)j * row;
    v = vbase + (size_t)j * row;
  }
  __device__ __forceinline__ void scales(int j, float& ks, float& vs) const {
    ks = ksb[j];
    vs = vsb[j];
  }
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
  // one division a key: its block and its position in the block
  __device__ __forceinline__ void rows(int j, const int8_t*& k, const int8_t*& v) const {
    const int q = j / bs;
    k = kv + (size_t)__ldg(table + min(q, mb - 1)) * 2 * page + (size_t)(j - q * bs) * row;
    v = k + page;
  }
  __device__ __forceinline__ void scales(int j, float& ks, float& vs) const {
    const int q = j / bs;
    const float* s = kvs + (size_t)__ldg(table + min(q, mb - 1)) * 2 * spage + (j - q * bs);
    ks = s[0];
    vs = s[spage];
  }
};

// q: the group's `group` query rows (group * d bf16, contiguous); `a` the
// addressor of this (request, kv head)'s keys. THREADS threads run it, tid
// the thread's index among them, sync() their barrier (the fused kernel
// runs two such crews a block). On return (all threads past a sync) sm.q
// holds the query rows in f32, sm.m / sm.l each row's running max and
// denominator (m = -inf, l = 0 when no slot is live), and acc[r] of thread
// tid < d the unnormalised output of row r, dimension tid. kRoundP rounds
// p * v_scale to bf16 before P@V (the fused kernel's numerics); otherwise
// it stays f32. A tile's K/V loads are all issued before its stores.
template <bool kRoundP, class Addr, class Sync>
static __device__ void attend(const __nv_bfloat16* __restrict__ q, const Addr& a,
                              int k_first, int k_last, int group, int d,
                              float scale, Smem& sm, float (&acc)[GMAX], int tid,
                              Sync sync) {
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = 8 * tid; i < group * d; i += 8 * THREADS) {   // d % 16 == 0
    const uint4 u = __ldcg(reinterpret_cast<const uint4*>(q + i));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sm.q[i / d][i % d + 2 * e] = __uint_as_float(w[e] << 16);
      sm.q[i / d][i % d + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
  if (tid < GMAX) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < GMAX; ++r) acc[r] = 0.f;
  sync();

  const int cpk = d / 16;                          // 16-byte chunks per key
  constexpr int PER = TILE * (DMAX / 16) / THREADS;  // chunks a thread, at most
  static_assert(TILE == THREADS, "a key's scales a thread");
  for (int j0 = k_first; j0 <= k_last; j0 += TILE) {
    const int n = min(TILE, k_last - j0 + 1);
    uint4 kr[PER], vr[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + i * THREADS;
      if (c < n * cpk) {
        const int key = c / cpk, part = c % cpk;
        const int8_t* kp;
        const int8_t* vp;
        a.rows(j0 + key, kp, vp);
        kr[i] = *reinterpret_cast<const uint4*>(kp + part * 16);
        vr[i] = *reinterpret_cast<const uint4*>(vp + part * 16);
      }
    }
    if (tid < n) a.scales(j0 + tid, sm.ks[tid], sm.vs[tid]);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + i * THREADS;
      if (c < n * cpk) {
        const int key = c / cpk, part = c % cpk;
        *reinterpret_cast<uint4*>(&sm.k[key * KLD + part * 16]) = kr[i];
        *reinterpret_cast<uint4*>(&sm.v[key * KLD + part * 16]) = vr[i];
      }
    }
    sync();

    // scores: one thread per key, the k-scale lands on the score; q four
    // dimensions a load, the key's bytes made f32 in registers
    if (tid < n) {
      float dot[GMAX];
#pragma unroll
      for (int r = 0; r < GMAX; ++r) dot[r] = 0.f;
      for (int c0 = 0; c0 < d; c0 += 16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(&sm.k[tid * KLD + c0]);
        const uint32_t words[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                                   raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          float kf[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) kf[e] = byte_f32(words[w4], e);
#pragma unroll
          for (int r = 0; r < GMAX; ++r) {
            if (r < group) {
              const float4 q4 = *reinterpret_cast<const float4*>(&sm.q[r][c0 + 4 * w4]);
              dot[r] += q4.x * kf[0];
              dot[r] += q4.y * kf[1];
              dot[r] += q4.z * kf[2];
              dot[r] += q4.w * kf[3];
            }
          }
        }
      }
      const float sk = sm.ks[tid] * scale;
#pragma unroll
      for (int r = 0; r < GMAX; ++r)
        if (r < group) sm.p[r][tid] = dot[r] * sk;
    }
    sync();

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
      // P @ V reads four keys a load: zeros past n
      for (int t = n + lane; t < ((n + 3) & ~3); t += 32) sm.p[r][t] = 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);   // 0 on the first tile
        sm.alpha[r] = alpha;
        sm.l[r] = sm.l[r] * alpha + sum;
        sm.m[r] = m_new;
      }
    }
    sync();

    // P @ V: one thread per output dimension
    if (tid < d) {
#pragma unroll
      for (int r = 0; r < GMAX; ++r)
        if (r < group) acc[r] *= sm.alpha[r];
      // four keys a step: p four keys a load, in key order as before
      for (int t = 0; t < n; t += 4) {
        float vf[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) vf[e] = static_cast<float>(sm.v[(t + e) * KLD + tid]);
#pragma unroll
        for (int r = 0; r < GMAX; ++r) {
          if (r < group) {
            const float4 p4 = *reinterpret_cast<const float4*>(&sm.p[r][t]);
            acc[r] += p4.x * vf[0];
            acc[r] += p4.y * vf[1];
            acc[r] += p4.z * vf[2];
            acc[r] += p4.w * vf[3];
          }
        }
      }
    }
    sync();
  }
}

// The loop run by a whole block of THREADS threads (K2, K6).
template <bool kRoundP, class Addr>
static __device__ void attend(const __nv_bfloat16* __restrict__ q, const Addr& a,
                              int k_first, int k_last, int group, int d,
                              float scale, Smem& sm, float (&acc)[GMAX]) {
  attend<kRoundP>(q, a, k_first, k_last, group, d, scale, sm, acc,
                  static_cast<int>(threadIdx.x), []() { __syncthreads(); });
}

}  // namespace kv_attn
