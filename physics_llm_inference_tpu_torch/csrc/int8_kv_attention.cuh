// The decode attention loop for one (request, kv head): one query token of
// each of the group's <= 8 query heads against the live keys [k_first,
// k_last].
//
// Shared by int8_kv_attention.cu (K2), paged_attention.cu (K6, K7) and
// fused_decode.cu (K4 in every mode, K8: their attention phase). It stands
// for the inner loops of the TPU kernels physics_llm_inference_tpu/kernels/
// int8_kv_attention.py (_kernel), paged_attention.py (_int8_paged_kernel,
// _paged_kernel) and fused_decode.py's attention step.
//
// Bound on the H100: the live KV bytes, each read once (~8 flop a byte at
// a group of 8, far below the tensor cores' ~295). So the design keeps
// loads in flight while it computes and keeps the arithmetic off the
// critical path:
// - the 4 warps of a crew each walk a contiguous share of the keys in steps
//   of 16, with their own online softmax (m, l and the output in
//   registers). They meet twice. Once each warp has scored its first two
//   steps, the largest of those scores of each row becomes every warp's
//   starting max: p * v_scale is rounded against it, so an item of up to
//   128 keys rounds as one softmax over its keys does (rounded against
//   each warp's own max instead, the fused kernel's W4A16 and W8A8 outputs
//   drift past chip_smoke.py's rules). At the end the four states merge in
//   warp order through shared memory. No barrier inside the key loop, no
//   atomics, two launches bit-equal;
// - each warp streams its steps' K and V rows (16-byte cp.async.cg; the
//   per-key scales by 4-byte cp.async) through its own two-step ring: a
//   place is refilled with the step two on once consumed, so the next
//   step's copies are in flight while a step computes, and the step after
//   the head is copied into the head's K rows as soon as they are scored,
//   before the crew meets (Place). One copy per 16-byte
//   chunk serves every addressor: a slot cache row (SlotAddr, K2, K4), a
//   block pool behind a table (PagedAddr, K6, K8; PagedBf16Addr, K7).
//   Keys past the range and dimensions past d are zero-filled by the copy;
//   dead keys' scores are masked to -inf;
// - both products are mma.sync.m16n8k16 bf16 with f32 accumulation. Scores
//   are S^T (16 keys x 8 query rows) = K Q^T: Q's B fragments are loaded
//   once an item, int8 keys are widened to bf16 in registers (exact:
//   |x| <= 128), the k-scale x softmax scale lands on the score. P@V is
//   O^T (d x 8) = V^T P^T: V's A fragment is read straight from its key
//   rows, and P^T's B fragment is made from the score accumulators by four
//   shuffles. With kRoundP, p * v_scale is rounded to bf16 (the fused
//   kernels' and K6's numerics, one mma); otherwise p (K7) or p * v_scale
//   (K2) is split into a bf16 high part and the bf16 of the remainder, two
//   mmas, relative error <= 2^-16 on each product;
// - the dimensions a lane owns are permuted so that every shared-memory
//   read is one conflict-free 16-byte load (Geo::kdim, Geo::vdim).
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace kv_attn {

constexpr int THREADS = 128;           // a crew
constexpr int WARPS = THREADS / 32;
constexpr int STEP = 16;               // keys a warp step: the mma's M
constexpr int STAGES = 2;              // a warp's ring: two steps
constexpr int DMAX = 128;              // head_dim limit
constexpr int GMAX = 8;                // query heads per kv head limit: the mma's N
constexpr unsigned FULL = 0xffffffffu;

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

// Two f32 that are exact in bf16 (the widened bytes), as a bf16 pair: their
// high halves, lo in the low one.
static __device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// bf16(lo), bf16(hi) rounded to nearest, lo in the low half.
static __device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

static __device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
static __device__ __forceinline__ float hi_f32(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2; bytes 0 zero-fills the destination
static __device__ __forceinline__ void cp16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void cp4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The ring's geometry for KV element E: int8 with per-key k and v scales
// (K2, K4, K6, K8) or bf16 without (K7).
template <class E>
struct Geo {
  static constexpr bool SCALED = sizeof(E) == 1;
  static constexpr int ROW = DMAX * static_cast<int>(sizeof(E));  // a padded key row
  static constexpr int LDB = ROW + 16;     // its stride in the ring: 16-byte reads conflict-free
  static constexpr int CH = ROW / 16;      // 16-byte copies a row
  static constexpr int SLOT = 2 * STEP * LDB + (SCALED ? 2 * STEP * 4 : 0);  // K, V, scales
  static constexpr int WARP_BYTES = STAGES * SLOT;
  // The first of the four dimensions that lane t4 (of the mma's quad)
  // holds in k16 chunk kk of Q and K (the order of a dot product's terms is
  // free): with a row in shared memory, a quad's reads of one key row hit
  // distinct banks.
  static __device__ __forceinline__ int kdim(int t4, int kk) {
    return SCALED ? 32 * t4 + 4 * kk : 64 * (kk >> 2) + 16 * t4 + 4 * (kk & 3);
  }
  // The output dimension of lane group g in m16 tile mt of O^T (the tile's
  // row g; its row g + 8 is the next dimension).
  static __device__ __forceinline__ int vdim(int g, int mt) {
    return SCALED ? 16 * g + 2 * mt : 64 * (mt >> 2) + 8 * g + 2 * (mt & 3);
  }
};

// A crew's shared memory: each warp's ring (after the loop: its output rows,
// (GMAX, DMAX) f32), the warps' softmax states, the merged ones, and two
// rows the fused kernel uses after the loop. int8: 38.4 KB; bf16: 70 KB.
template <class E>
struct __align__(16) Smem {
  unsigned char ring[WARPS][Geo<E>::WARP_BYTES];
  float hm[WARPS][GMAX];                  // the warps' maxima over their first steps
  float mw[WARPS][GMAX], lw[WARPS][GMAX];  // the warps' final states
  float m[GMAX], l[GMAX], alpha[GMAX], pc[GMAX];
};
static_assert(Geo<int8_t>::WARP_BYTES >= GMAX * DMAX * 4, "a warp's output rows fit its ring");
static_assert(Geo<int8_t>::WARP_BYTES % 16 == 0 && Geo<__nv_bfloat16>::WARP_BYTES % 16 == 0,
              "16-byte aligned rings");

// Key j of a slot cache row: kbase/vbase point at slot 0 of this head's
// cache row, `row` bytes between slots; ksb/vsb at slot 0 of its scales.
struct SlotAddr {
  const int8_t* kbase;
  const int8_t* vbase;
  const float* ksb;
  const float* vsb;
  size_t row;
  __device__ __forceinline__ const void* kb() const { return kbase; }
  __device__ __forceinline__ const void* vb() const { return vbase; }
  __device__ __forceinline__ const float* ks() const { return ksb; }
  __device__ __forceinline__ const float* vs() const { return vsb; }
  __device__ __forceinline__ size_t stride() const { return row; }
  // key j's rows at kb() / vb() + u * stride(), its scales at ks() / vs() + su
  __device__ __forceinline__ void locate(int j, uint32_t& u, uint32_t& su) const {
    u = su = static_cast<uint32_t>(j);
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
  __device__ __forceinline__ const void* kb() const { return kv; }
  __device__ __forceinline__ const void* vb() const { return kv + page; }
  __device__ __forceinline__ const float* ks() const { return kvs; }
  __device__ __forceinline__ const float* vs() const { return kvs + spage; }
  __device__ __forceinline__ size_t stride() const { return row; }
  // one division a key: its block and its position in the block
  __device__ __forceinline__ void locate(int j, uint32_t& u, uint32_t& su) const {
    const int q = j / bs, pos = j - q * bs;
    const uint32_t blk = static_cast<uint32_t>(__ldg(table + min(q, mb - 1)));
    u = blk * 2u * static_cast<uint32_t>(bs) + pos;
    su = blk * 2u * static_cast<uint32_t>(spage) + pos;
  }
};

// Key j of one request in the plain pools of one layer, (NB, BS, Hkv, d)
// bf16 each (K7): k/v point at block 0, position 0, head g; `row` bytes
// between positions (Hkv * d * 2). The column is clamped as PagedAddr's.
struct PagedBf16Addr {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* table;
  int bs, mb;
  size_t row;
  __device__ __forceinline__ const void* kb() const { return k; }
  __device__ __forceinline__ const void* vb() const { return v; }
  __device__ __forceinline__ const float* ks() const { return nullptr; }
  __device__ __forceinline__ const float* vs() const { return nullptr; }
  __device__ __forceinline__ size_t stride() const { return row; }
  __device__ __forceinline__ void locate(int j, uint32_t& u, uint32_t& su) const {
    const int q = j / bs;
    u = static_cast<uint32_t>(__ldg(table + min(q, mb - 1))) * static_cast<uint32_t>(bs) +
        (j - q * bs);
    su = 0;
  }
};

// q: the group's `group` query rows (group * d bf16, contiguous, 16-byte
// aligned; read through L2); `a` the addressor of this (request, kv head)'s
// keys, E its element. THREADS threads run it, tid the thread's index among
// them, sync() their barrier (the fused kernel runs two such crews a
// block). On return (all threads past a sync) sm.m / sm.l hold each row's
// max and denominator (m = -inf, l = 0 when no key is live), and acc[r] of
// thread tid < d the unnormalised output of row r, dimension tid.
template <bool kRoundP, class E, class Addr, class Sync>
static __device__ void attend(const __nv_bfloat16* __restrict__ q, const Addr& a,
                              int k_first, int k_last, int group, int d, float scale,
                              Smem<E>& sm, float (&acc)[GMAX], int tid, Sync sync) {
  using G = Geo<E>;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;     // mma fragment coordinates
  const int n = k_last - k_first + 1;
  const int steps = n > 0 ? (n + STEP - 1) / STEP : 0;
  const int s_first = warp * steps / WARPS, s_end = (warp + 1) * steps / WARPS;
  unsigned char* ring = sm.ring[warp];
  const uint32_t ring_s = smem_u32(ring);
  const int dbytes = d * static_cast<int>(sizeof(E));

  // Where a step lives in the warp's ring (byte offsets of its K rows, V
  // rows, k-scales and v-scales): places 0 and 1 are the two slots, each
  // K rows, V rows, then the scales; place 2 is the two slots' K rows and
  // the first halves of their scale rows, place 3 their V rows and the
  // second halves. Once the head's K rows are scored, place 2 is free, so
  // the step after the head is copied while the head's P@V waits for the
  // crew; places 2 and 3 then alternate.
  static_assert(STAGES == 2, "the head and the places are written for a two-step ring");
  struct Place {
    int k, v, ks, vs;
  };
  auto place = [](int p) {
    constexpr int S = G::SLOT, V = STEP * G::LDB, SC = 2 * STEP * G::LDB;
    if (p < 2) return Place{p * S, p * S + V, p * S + SC, p * S + SC + 4 * STEP};
    const int h = p - 2;
    return Place{h * V, S + h * V, SC + 4 * STEP * h, S + SC + 4 * STEP * h};
  };

  // step s's K and V rows (and scales) into place p: lane l locates key
  // l % 16, then each copy instruction moves 32 consecutive 16-byte chunks
  // (whole rows, in row order: K rows, then V rows)
  auto fetch = [&](int s, int p) {
    const int j0 = k_first + STEP * s, nk = min(STEP, k_last - j0 + 1);
    const int key = lane & (STEP - 1);
    uint32_t u = 0, su = 0;
    if (key < nk) a.locate(j0 + key, u, su);
    const Place at = place(p);
    const char* kb = static_cast<const char*>(a.kb());
    const char* vb = static_cast<const char*>(a.vb());
    const size_t row = a.stride();
#pragma unroll
    for (int i = 0; i < G::CH; ++i) {
      const int idx = i * 32 + lane, r = idx / G::CH, c = idx % G::CH;
      const int kr = r & (STEP - 1);
      const uint32_t ur = __shfl_sync(FULL, u, kr);
      const bool live = kr < nk && c * 16 < dbytes;
      const char* base = r < STEP ? kb : vb;
      const int to = r < STEP ? at.k + r * G::LDB : at.v + (r - STEP) * G::LDB;
      cp16(ring_s + to + c * 16, live ? base + (size_t)ur * row + c * 16 : base,
           live ? 16 : 0);
    }
    if constexpr (G::SCALED) {   // lanes 0-15 the k-scales, 16-31 the v-scales
      const float* sb = lane < STEP ? a.ks() : a.vs();
      cp4(ring_s + (lane < STEP ? at.ks : at.vs) + key * 4, key < nk ? sb + su : sb,
          key < nk ? 4 : 0);
    }
  };

  sync();   // the caller's last use of sm is over
#pragma unroll
  for (int i = 0; i < 2; ++i) {   // the head: places 0 and 1
    if (s_first + i < s_end) fetch(s_first + i, i);
    cp_commit();
  }

  // Q^T's B fragments, chunk kk: query row g, dimensions kdim(t4, kk) + 0..3
  // (zero past the group and past d)
  uint32_t qf[DMAX / 16][2];
#pragma unroll
  for (int c = 0; c < DMAX / 32; ++c) {
    const int dim = G::kdim(t4, 2 * c);   // 8 contiguous dimensions: chunks 2c, 2c + 1
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (g < group && dim < d) u = __ldcg(reinterpret_cast<const uint4*>(q + g * d + dim));
    qf[2 * c][0] = u.x;
    qf[2 * c][1] = u.y;
    qf[2 * c + 1][0] = u.z;
    qf[2 * c + 1][1] = u.w;
  }

  // this lane's two query rows 2 t4 and 2 t4 + 1: running max, partial
  // denominator (its own keys), and O^T's accumulators of m16 tile mt
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[DMAX / 16][4];
#pragma unroll
  for (int mt = 0; mt < DMAX / 16; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
  // P^T's B fragment: keys 2 t4, 2 t4 + 1 (+ 8) of row g, from the lanes
  // whose score accumulators hold them (key = their g, rows 2 of their t4)
  const int src0 = 8 * t4 + (g >> 1), src1 = src0 + 4;
  const uint32_t sel = (g & 1) ? 0x7632u : 0x5410u;

  // the scores of step s in place p: S^T = K Q^T, this lane's keys g, g + 8
  // of the step and rows 2 t4, 2 t4 + 1, times the k-scale and the softmax
  // scale; -inf past the range
  auto scores = [&](int s, int p, float (&sc)[4]) {
    const Place at = place(p);
    const unsigned char* K = ring + at.k;
    const int nk = min(STEP, k_last - (k_first + STEP * s) + 1);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (G::SCALED) {
      const uint4* kg = reinterpret_cast<const uint4*>(K + g * G::LDB + 32 * t4);
      const uint4* kh = reinterpret_cast<const uint4*>(K + (g + 8) * G::LDB + 32 * t4);
      const uint4 x0 = kg[0], x1 = kg[1], y0 = kh[0], y1 = kh[1];
      const uint32_t wg[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const uint32_t wh[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        const uint32_t xg = wg[kk] ^ 0x80808080u, xh = wh[kk] ^ 0x80808080u;
        const uint32_t af[4] = {pack_exact(byte_f32(xg, 0), byte_f32(xg, 1)),
                                pack_exact(byte_f32(xh, 0), byte_f32(xh, 1)),
                                pack_exact(byte_f32(xg, 2), byte_f32(xg, 3)),
                                pack_exact(byte_f32(xh, 2), byte_f32(xh, 3))};
        mma(c, af, qf[kk][0], qf[kk][1]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4* kg = reinterpret_cast<const uint4*>(K + g * G::LDB + 128 * h + 32 * t4);
        const uint4* kh =
            reinterpret_cast<const uint4*>(K + (g + 8) * G::LDB + 128 * h + 32 * t4);
        const uint4 x0 = kg[0], x1 = kg[1], y0 = kh[0], y1 = kh[1];
        const uint32_t wg[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const uint32_t wh[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t af[4] = {wg[2 * e], wh[2 * e], wg[2 * e + 1], wh[2 * e + 1]};
          mma(c, af, qf[4 * h + e][0], qf[4 * h + e][1]);
        }
      }
    }
    const float* ksm = reinterpret_cast<const float*>(ring + at.ks);
    const float sk0 = G::SCALED ? ksm[g] * scale : scale;
    const float sk8 = G::SCALED ? ksm[g + 8] * scale : scale;
    const bool live0 = g < nk, live8 = g + 8 < nk;
    sc[0] = live0 ? c[0] * sk0 : -INFINITY;
    sc[1] = live0 ? c[1] * sk0 : -INFINITY;
    sc[2] = live8 ? c[2] * sk8 : -INFINITY;
    sc[3] = live8 ? c[3] * sk8 : -INFINITY;
  };

  // the online softmax and P@V of the step in place p, scores sc
  auto accumulate = [&](int p, const float (&sc)[4]) {
    const Place at = place(p);
    const unsigned char* V = ring + at.v;
    // online softmax over the step's keys (the lanes of one t4)
    float mx0 = fmaxf(sc[0], sc[2]), mx1 = fmaxf(sc[1], sc[3]);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);   // finite: key 0 is live
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);   // 1 while the start holds
    m0 = mn0;
    m1 = mn1;
    float x[4] = {expf(sc[0] - mn0), expf(sc[1] - mn1), expf(sc[2] - mn0), expf(sc[3] - mn1)};
    l0 = l0 * al0 + (x[0] + x[2]);
    l1 = l1 * al1 + (x[1] + x[3]);
    if constexpr (G::SCALED) {
      const float* vsm = reinterpret_cast<const float*>(ring + at.vs);
      const float v0 = vsm[g], v8 = vsm[g + 8];
      x[0] *= v0;
      x[1] *= v0;
      x[2] *= v8;
      x[3] *= v8;
    }
#pragma unroll
    for (int mt = 0; mt < DMAX / 16; ++mt) {
      o[mt][0] *= al0;
      o[mt][1] *= al1;
      o[mt][2] *= al0;
      o[mt][3] *= al1;
    }

    // P^T's B fragments (kRoundP: bf16(x); otherwise x's high and low parts)
    const uint32_t w01 = pack_rn(x[0], x[1]), w23 = pack_rn(x[2], x[3]);
    uint32_t bh[2], bl[2] = {0u, 0u};
    {
      const uint32_t x0 = __shfl_sync(FULL, w01, src0), x1 = __shfl_sync(FULL, w01, src1);
      const uint32_t y0 = __shfl_sync(FULL, w23, src0), y1 = __shfl_sync(FULL, w23, src1);
      bh[0] = __byte_perm(x0, x1, sel);
      bh[1] = __byte_perm(y0, y1, sel);
    }
    if constexpr (!kRoundP) {
      const uint32_t r01 = pack_rn(x[0] - lo_f32(w01), x[1] - hi_f32(w01));
      const uint32_t r23 = pack_rn(x[2] - lo_f32(w23), x[3] - hi_f32(w23));
      const uint32_t x0 = __shfl_sync(FULL, r01, src0), x1 = __shfl_sync(FULL, r01, src1);
      const uint32_t y0 = __shfl_sync(FULL, r23, src0), y1 = __shfl_sync(FULL, r23, src1);
      bl[0] = __byte_perm(x0, x1, sel);
      bl[1] = __byte_perm(y0, y1, sel);
    }

    // O^T += V^T P^T: tile mt's A holds dimensions vdim(g, mt) (+1) of keys
    // 2 t4, 2 t4 + 1 (+ 8)
    if constexpr (G::SCALED) {
      const unsigned char* vr = V + 2 * t4 * G::LDB + 16 * g;
      const uint4 r0 = *reinterpret_cast<const uint4*>(vr);
      const uint4 r1 = *reinterpret_cast<const uint4*>(vr + G::LDB);
      const uint4 r8 = *reinterpret_cast<const uint4*>(vr + 8 * G::LDB);
      const uint4 r9 = *reinterpret_cast<const uint4*>(vr + 9 * G::LDB);
      const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w}, w1[4] = {r1.x, r1.y, r1.z, r1.w};
      const uint32_t w8[4] = {r8.x, r8.y, r8.z, r8.w}, w9[4] = {r9.x, r9.y, r9.z, r9.w};
#pragma unroll
      for (int mt = 0; mt < DMAX / 16; ++mt) {
        const int wi = mt >> 1, b = 2 * (mt & 1);
        const uint32_t x0 = w0[wi] ^ 0x80808080u, x1 = w1[wi] ^ 0x80808080u;
        const uint32_t x8 = w8[wi] ^ 0x80808080u, x9 = w9[wi] ^ 0x80808080u;
        const uint32_t af[4] = {pack_exact(byte_f32(x0, b), byte_f32(x1, b)),
                                pack_exact(byte_f32(x0, b + 1), byte_f32(x1, b + 1)),
                                pack_exact(byte_f32(x8, b), byte_f32(x9, b)),
                                pack_exact(byte_f32(x8, b + 1), byte_f32(x9, b + 1))};
        mma(o[mt], af, bh[0], bh[1]);
        if constexpr (!kRoundP) mma(o[mt], af, bl[0], bl[1]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned char* vr = V + 2 * t4 * G::LDB + 128 * h + 16 * g;
        const uint4 r0 = *reinterpret_cast<const uint4*>(vr);
        const uint4 r1 = *reinterpret_cast<const uint4*>(vr + G::LDB);
        const uint4 r8 = *reinterpret_cast<const uint4*>(vr + 8 * G::LDB);
        const uint4 r9 = *reinterpret_cast<const uint4*>(vr + 9 * G::LDB);
        const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w}, w1[4] = {r1.x, r1.y, r1.z, r1.w};
        const uint32_t w8[4] = {r8.x, r8.y, r8.z, r8.w}, w9[4] = {r9.x, r9.y, r9.z, r9.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t af[4] = {
              __byte_perm(w0[e], w1[e], 0x5410), __byte_perm(w0[e], w1[e], 0x7632),
              __byte_perm(w8[e], w9[e], 0x5410), __byte_perm(w8[e], w9[e], 0x7632)};
          mma(o[4 * h + e], af, bh[0], bh[1]);
          if constexpr (!kRoundP) mma(o[4 * h + e], af, bl[0], bl[1]);
        }
      }
    }
  };

  // The crew's start: each warp's first two steps land and are scored,
  // and the largest score of every row among them becomes every warp's
  // starting max. p * v_scale is rounded against that max, so an item of
  // up to 2 * WARPS steps (128 keys) rounds as one softmax over its keys
  // would; a warp whose later steps hold a larger score raises its own.
  const int head = max(0, min(2, s_end - s_first));
  float hs[2][4];
  float hx0 = -INFINITY, hx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i == 0) cp_wait<1>();
    else cp_wait<0>();
    __syncwarp();
    if (i < head) {
      scores(s_first + i, i, hs[i]);
      hx0 = fmaxf(hx0, fmaxf(hs[i][0], hs[i][2]));
      hx1 = fmaxf(hx1, fmaxf(hs[i][1], hs[i][3]));
    }
  }
  __syncwarp();   // the head's K rows are read: place 2 is free
  if (s_first + 2 < s_end) fetch(s_first + 2, 2);
  cp_commit();
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    hx0 = fmaxf(hx0, __shfl_xor_sync(FULL, hx0, off));
    hx1 = fmaxf(hx1, __shfl_xor_sync(FULL, hx1, off));
  }
  if (g == 0) {
    sm.hm[warp][2 * t4] = hx0;
    sm.hm[warp][2 * t4 + 1] = hx1;
  }
  sync();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    m0 = fmaxf(m0, sm.hm[w][2 * t4]);
    m1 = fmaxf(m1, sm.hm[w][2 * t4 + 1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (i < head) accumulate(i, hs[i]);
  __syncwarp();   // the head's V rows are read: place 3 is free
  if (s_first + 3 < s_end) fetch(s_first + 3, 3);
  cp_commit();

  // the rest, in places 2 and 3 by turns: a place is refilled with the
  // step two on once consumed, so the next step's copies are in flight
  // while a step computes; no barrier
  for (int s = s_first + 2; s < s_end; ++s) {
    const int p = 2 + ((s - s_first) & 1);
    cp_wait<1>();
    __syncwarp();
    float sc[4];
    scores(s, p, sc);
    accumulate(p, sc);
    __syncwarp();
    if (s + 2 < s_end) fetch(s + 2, p);
    cp_commit();
  }
  cp_wait<0>();
  __syncwarp();

  // this warp's state into shared memory: its output rows over its ring
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, off);
    l1 += __shfl_xor_sync(FULL, l1, off);
  }
  float* ow = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int mt = 0; mt < DMAX / 16; ++mt) {
    const int dm = G::vdim(g, mt);
    *reinterpret_cast<float2*>(ow + 2 * t4 * DMAX + dm) = make_float2(o[mt][0], o[mt][2]);
    *reinterpret_cast<float2*>(ow + (2 * t4 + 1) * DMAX + dm) = make_float2(o[mt][1], o[mt][3]);
  }
  if (g == 0) {
    sm.mw[warp][2 * t4] = m0;
    sm.mw[warp][2 * t4 + 1] = m1;
    sm.lw[warp][2 * t4] = l0;
    sm.lw[warp][2 * t4 + 1] = l1;
  }
  sync();

  // the four states merged in warp order (a warp with no key: m = -inf)
#pragma unroll
  for (int r = 0; r < GMAX; ++r) acc[r] = 0.f;
  if (tid < d) {
#pragma unroll
    for (int r = 0; r < GMAX; ++r) {
      if (r < group) {
        float mr = sm.mw[0][r];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) mr = fmaxf(mr, sm.mw[w][r]);
        float lr = 0.f, out = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const float mw = sm.mw[w][r];
          const float f = mw == -INFINITY ? 0.f : expf(mw - mr);
          lr += f * sm.lw[w][r];
          out += f * reinterpret_cast<const float*>(sm.ring[w])[r * DMAX + tid];
        }
        acc[r] = out;
        if (tid == r) {
          sm.m[r] = mr;
          sm.l[r] = lr;
        }
      }
    }
  }
  sync();
}

// A block's output rows (K2, K6, K7): out[r * d + dim] = acc / l, 0 where
// no key was live.
template <class E>
static __device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                                  const float (&acc)[GMAX], const Smem<E>& sm,
                                                  int group, int d) {
  const int tid = threadIdx.x;
  if (tid >= d) return;
#pragma unroll
  for (int r = 0; r < GMAX; ++r) {
    if (r < group) {
      const float l = sm.l[r];
      out[(size_t)r * d + tid] = __float2bfloat16(acc[r] / (l > 0.f ? l : 1.f));
    }
  }
}

// The loop run by a whole block of THREADS threads (K2, K6, K7).
template <bool kRoundP, class E, class Addr>
static __device__ void attend(const __nv_bfloat16* __restrict__ q, const Addr& a,
                              int k_first, int k_last, int group, int d, float scale,
                              Smem<E>& sm, float (&acc)[GMAX]) {
  attend<kRoundP>(q, a, k_first, k_last, group, d, scale, sm, acc,
                  static_cast<int>(threadIdx.x), []() { __syncthreads(); });
}

}  // namespace kv_attn
