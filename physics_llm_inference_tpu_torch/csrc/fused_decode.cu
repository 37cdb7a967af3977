// K4 and K8: the whole INT8-KV decode step for all layers, in one launch.
//
// K4 replaces the TPU kernel physics_llm_inference_tpu/kernels/
// fused_decode.py (fused_decode_step -> _kernel) in its three modes, each an
// instance of fused_decode_stream_kernel<kMode, false> (the mode is a
// template parameter; no inner loop branches on it at run time):
//  - W8A16, the default: int8 weights, bf16 activations, f32 partials of
//    the GEMM phases, the per-channel scale after their sum;
//  - W4A16 (the `w4` body): nibble-packed INT4 weights with group scales.
//    A unit reads each packed byte once and makes both output columns it
//    holds (j and N/2 + j); each scale group's f32 sum is scaled by its
//    scale row and added in K order (the TPU kernel's `acc += part * s` per
//    K-tile), so the workspace receives scaled partials;
//  - W8A8 (the `act8` body, act_quant = "int8"): each activation row is
//    quantized to int8 over its absmax after ln1, after attention (one more
//    phase a layer), after ln2 and after silu (two grid-wide phases: the f32
//    silu row and its absmax, then its codes), into `a8` with its scale in
//    `asc`; the int8 x int8 products accumulate exact int32 partials, summed
//    as integers, then (f32(sum) * row_scale) * w_scale.
// K8 replaces fused_paged_decode_step -> _paged_kernel_r5 of the same file:
// the W8A16 kernel with a paged address mode in the attention phase only
// (fused_decode_stream_kernel<W8A16, true>). Its KV lives in the merged INT8
// block pools (L, NB, 2, BS, Hkv*d) / (L, NB, 2, Hkv, BS) f32 reached through
// the block table; request b attends its keys [0, lengths[b]) plus the
// current token and writes the new codes and scales at position lengths[b]
// of block tables[b, min(lengths[b] / BS, MB - 1)]. Of the TPU kernel's
// machinery (request groups, rotating value rings, the layer-resident scale
// copy, DMA semaphores, 8-slot write windows) nothing is needed here: a pool
// row is addressed directly. Per layer: RMSNorm, QKV, RoPE, KV quantize,
// attention over the INT8 cache plus the current token, the cache write, WO,
// RMSNorm, gate/up, silu * up, down. The numerics are the TPU kernel's: the
// residual stream stays f32 across all layers and is cast to bf16 once at
// the end; qkv, gate and up are rounded to bf16 after their f32 sums; K is
// rounded to bf16 after RoPE and quantized per head; the current token
// attends through the dequantized int8 values the cache will hold; p *
// v_scale is rounded to bf16 before P@V.
//
// Bound on the H100: weight bytes (at B = 64 every int8 weight byte feeds 128
// operations, every packed INT4 byte 256, far below the ~295 flop/byte bf16
// and ~590 op/byte int8 ridges) plus the live KV bytes. The TPU kernel keeps
// activations in VMEM and walks one sequential grid, its weights streaming
// through VMEM double-buffered across phase and layer boundaries alike; here
// one persistent cooperative launch covers the step, one block an SM of 8
// consumer warps and a producer warpgroup, and the phases of a layer are
// separated by grid-wide barriers:
//   1. QKV partials;  2. per (request, kv head): the fixed-order sum of the
//      partials, bf16, RoPE, quantize K/V into the new-KV buffers;
//   3. per (request, kv head): attention over the cache slots [valid_from,
//      q_slot) (kv_attn::attend, the tensor-core loop of K2, K6 and K7: a
//      crew's four warps split the keys, each streams them through its own
//      cp.async ring; K8: the request's pool blocks through the table),
//      merged with the current token;
//      (W8A8: per request, the attention row quantized);
//   4. WO partials, and the new K/V written to the cache (after every read
//      of it in phase 3);  5. per request: x += sum * scale, then RMSNorm ->
//      h;  6. gate/up partials;  7. silu(gate) * up -> ff (W8A8: the f32 row
//      and its absmax, then its codes);  8. DOWN partials;  9. per request:
//      x += sum * scale, then the next layer's RMSNorm (or the bf16 output
//      after the last layer).
// The GEMM phases are w8a16_stream.cuh: a plan made on the host splits each
// phase's (slab, k-tile) units evenly over the blocks (stream-K), and the
// producer streams every weight tile the block will consume, of every phase
// and layer, through a TMA ring in shared memory, running ahead across the
// grid barriers: the row, RoPE and attention phases do not leave the weight
// stream idle. The grid barrier is written by hand over the consumer warps
// (a named barrier, then one thread's release/acquire on a counter the
// launch zeroes), so the producer, which may wait on a free stage, stays out
// of it. The other phases run on crews of 128 threads, two a block (named
// barriers 2 and 3), or, the per-request row phases, on whole blocks.
// Partials go to a workspace and are summed in a fixed order (no float
// atomics: W8A8's silu absmax is an integer max of non-negative floats'
// bits, which no order changes), so the step is deterministic; the summing
// phases read them four columns a load, every partial in flight. L1 is not
// coherent across SMs, so everything another block wrote in this launch is
// read through L2 (ld.global.cg).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_kv_attention.cuh"
#include "w8a16_stream.cuh"

namespace {

using w8s::W4A16;
using w8s::W8A16;
using w8s::W8A8;

constexpr int CREW = 128;      // a crew: the RoPE and attention phases' worker
static_assert(CREW == kv_attn::THREADS, "the attention loop's block shape");
static_assert(w8s::CONSUMERS == 2 * CREW, "two crews a block");
constexpr int MAX_WARPS = w8s::CONSUMERS / 32;   // the widest crew: a block
constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// W8A8: the rows of `asc`, one per activation quantization point, then the
// silu row's absmax (the float's bits, atomicMax'd).
constexpr int ASC_LN1 = 0, ASC_ATTN = 1, ASC_LN2 = 2, ASC_FF = 3, ASC_FFMAX = 4;
// The GEMM phases, in a layer's order.
constexpr int QKV = 0, WO = 1, GU = 2, DN = 3;

// W8A8: the bytes between two int8 activation rows of width n, a multiple
// of 16 (a TMA stride must be).
static __host__ __device__ __forceinline__ int row_pitch(int n) { return (n + 15) & ~15; }

struct Params {
  const __nv_bfloat16* x0;                 // (B, D)
  const __nv_bfloat16* ln1;                // (L, D)
  const __nv_bfloat16* ln2;                // (L, D)
  const int8_t* wqkv; const float* sqkv;   // (L, D, QO), (L, QO)
  const int8_t* wo; const float* swo;      // (L, HQ*HD, D), (L, D)
  const int8_t* wgu; const float* sgu;     // (L, D, 2F), (L, 2F)
  const int8_t* wdn; const float* sdn;     // (L, F, D), (L, D); W4A16: the
                                           // packed (L, K, N/2) bytes and
                                           // (L, K/G, N) group scales
  int8_t* kq; float* ks;                   // (L, B, S, HKV*HD), (L, B, HKV, S)
  int8_t* vq; float* vs;                   // K8: kq/ks are the merged pools
                                           // (L, NB, 2, BS, HKV*HD) and
                                           // (L, NB, 2, HKV, BS); vq/vs unused
  const int* tables;                       // K8: (B, MB) block table
  const float* cos; const float* sin;      // (B, HD/2)
  const int* q_slot; const int* valid_from;  // (B,); K8: q_slot = lengths
  int8_t* k_new; float* ks_new;            // (L, B, HKV*HD), (L, B, HKV)
  int8_t* v_new; float* vs_new;
  __nv_bfloat16* x_out;                    // (B, D)
  float* xf;                               // (B, D) f32 residual stream
  __nv_bfloat16* h;                        // (B, D) normed activations
  __nv_bfloat16* qbuf;                     // (B, HQ*HD) post-RoPE queries
  __nv_bfloat16* attn;                     // (B, HQ*HD)
  __nv_bfloat16* ff;                       // (B, F)
  float* ws;                               // the partials (j, B, N): f32
                                           // (W8A8: int32)
  int8_t* a8;                              // W8A8: (B, row_pitch(K)) int8 rows
  float* asc;                              // W8A8: (5, B) their scales, absmax
  float* ffs;                              // W8A8: (B, F) f32 silu(gate) * up
  unsigned* sync;                          // the grid barrier's counter, then
                                           // the attention items claimed
  int L, B, S, D, F, HQ, HKV, HD;
  int NB, MB, BS;                          // K8: pool blocks, table width, block size
  const int* slot;                         // K4, write_cache: (B,) write slots
  int write_cache;
  w8s::Plan plan[4];                       // each GEMM phase's plan
  int g_qkv, g_wo, g_gu, g_dn;             // W4A16: K rows of a scale group
  float eps, scale;
  unsigned long long* clock;               // the phase clock, or null
};

// The phase clock: with p.clock set, thread 0 of block 0 writes
// %globaltimer (ns) into clock[n] once it has seen the n-th grid barrier
// complete, so clock[n + 1] - clock[n] is phase n + 1's time as block 0 saw
// it.
static __device__ __forceinline__ void stamp(const Params& p, int n) {
  if (p.clock != nullptr && blockIdx.x == 0) p.clock[n] = w8s::global_ns();
}

// A crew of `size` threads: `count` of them walk a phase's items, crew `id`
// of them; `tid` is the thread's index in it and `bar` its named barrier.
// Crews are half blocks (CREW threads); the row phases run on whole blocks
// (w8s::CONSUMERS).
struct Crew {
  int id, count, tid, bar, size;
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(size) : "memory");
  }
};

// The crews of a phase, made anew from the thread index (w8s::tid_x): half
// a block (the RoPE, attention and cache-write phases; named barriers 2 and
// 3) or the whole block (the per-request row phases). Made once for the
// launch, they stayed live across the GEMM phases, which take every
// register they may.
static __device__ __forceinline__ Crew half_crew() {
  const int t = w8s::tid_x(), half = t / CREW;
  return Crew{static_cast<int>(blockIdx.x) * 2 + half, static_cast<int>(gridDim.x) * 2,
              t % CREW, 2 + half, CREW};
}

static __device__ __forceinline__ Crew block_crew() {
  return Crew{static_cast<int>(blockIdx.x), static_cast<int>(gridDim.x), w8s::tid_x(),
              w8s::BAR_CONSUMERS, w8s::CONSUMERS};
}

// A crew's shared memory in the row, RoPE and attention phases.
struct CrewSmem {
  kv_attn::Smem<int8_t> att;
  float kv[2 * kv_attn::DMAX];             // one head's K and V rows
  float red[MAX_WARPS];
  double red_d[MAX_WARPS];
  int item;                                // a claimed attention item
};

static __device__ __forceinline__ float block_sum(float v, const Crew& c, float* red) {
  const int lane = c.tid & 31, warp = c.tid >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  c.sync();
  float t = 0.f;
  for (int w = 0; w < c.size / 32; ++w) t += red[w];
  c.sync();
  return t;
}

static __device__ __forceinline__ double block_sum_d(double v, const Crew& c,
                                                     double* red) {
  const int lane = c.tid & 31, warp = c.tid >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  c.sync();
  double t = 0.0;
  for (int w = 0; w < c.size / 32; ++w) t += red[w];
  c.sync();
  return t;
}

static __device__ __forceinline__ float block_max(float v, const Crew& c, float* red) {
  const int lane = c.tid & 31, warp = c.tid >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  c.sync();
  float t = red[0];
  for (int w = 1; w < c.size / 32; ++w) t = fmaxf(t, red[w]);
  c.sync();
  return t;
}

static __device__ __forceinline__ float bf(float x) { return kv_attn::round_bf16(x); }

static __device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

static __device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

static __device__ __forceinline__ void add4(int4& a, const int4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// Columns n..n+3 (n % 4 == 0, N % 4 == 0) of request b of the partials ws
// (cnt, B, N) of type V (float4, W8A8 int4), summed in partial order, BATCH
// loads in flight, so a plan's partials are read in one round.
template <class V, int BATCH>
static __device__ __forceinline__ V partial_batch4(const float* ws, int cnt, int B, int N, int b,
                                                 int n) {
  const V* w = reinterpret_cast<const V*>(ws);
  V acc{};
  for (int j0 = 0; j0 < cnt; j0 += BATCH) {
    V v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      v[j] = j0 + j < cnt ? __ldcg(w + (((size_t)(j0 + j) * B + b) * N + n) / 4) : V{};
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (j0 + j < cnt) add4(acc, v[j]);
  }
  return acc;
}

// The same with as many loads in flight as the column has partials.
template <class V>
static __device__ __forceinline__ V partial_sum4(const float* ws, int cnt, int B, int N, int b,
                                                 int n) {
  return cnt <= 4   ? partial_batch4<V, 4>(ws, cnt, B, N, b, n)
         : cnt <= 8 ? partial_batch4<V, 8>(ws, cnt, B, N, b, n)
                    : partial_batch4<V, 16>(ws, cnt, B, N, b, n);
}

// Outputs (b, n..n+3) of GEMM phase `ph` from its plan's partials of that
// column: W8A16 the sum * scale; W4A16 the sum (the partials carry their
// group scales); W8A8 (f32(integer sum) * rs) * scale, rs the input row's
// scale.
template <int kMode>
static __device__ __forceinline__ float4 gemm_out4(const Params& p, int ph, int N, int b,
                                                   int n, const float* scale, float rs) {
  const int cnt = w8s::partials<kMode>(p.plan[ph], b, n, N);
  if constexpr (kMode == W4A16) return partial_sum4<float4>(p.ws, cnt, p.B, N, b, n);
  const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + n));
  if constexpr (kMode == W8A16) {
    const float4 v = partial_sum4<float4>(p.ws, cnt, p.B, N, b, n);
    return make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
  } else {
    const int4 v = partial_sum4<int4>(p.ws, cnt, p.B, N, b, n);
    return make_float4(static_cast<float>(v.x) * rs * sc.x, static_cast<float>(v.y) * rs * sc.y,
                       static_cast<float>(v.z) * rs * sc.z, static_cast<float>(v.w) * rs * sc.w);
  }
}

// W8A8: the int8 code of v at scale s: clip(rint(v / s), +-127).
static __device__ __forceinline__ int8_t code8(float v, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

// W8A8: the scale of a row of absmax `amax`: max(amax, 1e-8) * (1/127), the
// form in which XLA gives the TPU kernel's `_qrow`.
static __device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(amax, 1e-8f) * (1.f / 127.f);
}

// W8A8: row b of width n, value(i) in f32, to int8 codes in a8 (rows
// row_pitch(n) bytes apart), its scale to *scale_out.
template <class Value>
static __device__ void quantize_row(const Params& p, const Crew& c, float* red, int b,
                                    int n, float* scale_out, Value value) {
  float amax = 0.f;
  for (int i = c.tid; i < n; i += c.size) amax = fmaxf(amax, fabsf(value(i)));
  const float s = row_scale(block_max(amax, c, red));
  int8_t* row = p.a8 + (size_t)b * row_pitch(n);
  for (int i = c.tid; i < n; i += c.size) row[i] = code8(value(i), s);
  if (c.tid == 0) *scale_out = s;
}

static __device__ __forceinline__ float4 ldbf4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

static __device__ __forceinline__ void stbf4(__nv_bfloat16* p, float a, float b, float c,
                                             float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Per request b: x = x0 (init) or x += GEMM phase ph's output (its
// partials, `scale`, and for W8A8 the input row scale asc[in_row]); then
// h = bf16(rms(x) * ln) when ln is given, else x_out = bf16(x). Four
// columns a thread a step. W8A8: the f32 rms(x) * ln is quantized into a8,
// its scale to asc[out_row]; the mean of squares is summed in f64 and
// rounded once, and 1 / sqrtf is IEEE, as the plain version's `_rms_exact`:
// the row is not rounded to bf16 before its codes, so its last bit decides
// codes at exact .5 ties.
template <int kMode>
static __device__ void rows_phase(const Params& p, const Crew& c, CrewSmem& cs,
                                  const float* scale, int ph, int in_row,
                                  const __nv_bfloat16* ln, int out_row, bool init) {
  const int D = p.D;
  for (int b = c.id; b < p.B; b += c.count) {
    float* xr = p.xf + (size_t)b * D;
    float rs = 0.f;
    if constexpr (kMode == W8A8) {
      if (!init) rs = __ldcg(p.asc + (size_t)in_row * p.B + b);
    }
    float ss = 0.f;
    double ss_d = 0.0;
    for (int n = 4 * c.tid; n < D; n += 4 * c.size) {
      float4 x;
      if (init) {
        x = ldbf4(p.x0 + (size_t)b * D + n);
      } else {
        x = ldcg4(xr + n);
        add4(x, gemm_out4<kMode>(p, ph, D, b, n, scale, rs));
      }
      *reinterpret_cast<float4*>(xr + n) = x;
      if constexpr (kMode == W8A8) {
        ss_d += static_cast<double>(x.x) * x.x + static_cast<double>(x.y) * x.y +
                static_cast<double>(x.z) * x.z + static_cast<double>(x.w) * x.w;
      } else {
        ss += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
      }
    }
    if (ln != nullptr) {
      if constexpr (kMode == W8A8) {
        const float ms = static_cast<float>(block_sum_d(ss_d, c, cs.red_d) / D);
        const float r = 1.f / sqrtf(ms + p.eps);
        quantize_row(p, c, cs.red, b, D, p.asc + (size_t)out_row * p.B + b,
                     [&](int n) { return __ldcg(xr + n) * r * __bfloat162float(ln[n]); });
      } else {
        const float tot = block_sum(ss, c, cs.red);
        const float r = 1.f / sqrtf(tot / D + p.eps);
        for (int n = 4 * c.tid; n < D; n += 4 * c.size) {
          const float4 x = ldcg4(xr + n);
          const float4 w = ldbf4(ln + n);
          stbf4(p.h + (size_t)b * D + n, x.x * r * w.x, x.y * r * w.y, x.z * r * w.z,
                x.w * r * w.w);
        }
      }
    } else {
      for (int n = 4 * c.tid; n < D; n += 4 * c.size) {
        const float4 x = ldcg4(xr + n);
        stbf4(p.x_out + (size_t)b * D + n, x.x, x.y, x.z, x.w);
      }
    }
    c.sync();
  }
}

// Per (request, kv head): qkv = bf16(the QKV phase's output); RoPE on the
// group's query heads -> qbuf (bf16); K rotated and rounded to bf16, V as
// is; both quantized per head (absmax / 127, round half to even, clip +-127)
// into the new-KV buffers of layer l. The item's group + 2 heads are first
// summed from their partials into shared memory, four columns a thread a
// step with every partial load in flight, then rotated from there.
template <int kMode>
static __device__ void qkv_phase(const Params& p, const Crew& c, CrewSmem& cs, int l) {
  const int HD = p.HD, hd2 = HD / 2, group = p.HQ / p.HKV;
  const int QH = p.HQ * HD, KH = p.HKV * HD, QO = QH + 2 * KH;
  const float* sc = p.sqkv + (size_t)l * QO;
  float* qkv = reinterpret_cast<float*>(cs.att.ring);   // (group + 2) x HD
  float* kf = cs.kv;
  float* vf = cs.kv + HD;
  for (int it = c.id; it < p.B * p.HKV; it += c.count) {
    const int b = it / p.HKV, g = it % p.HKV;
    const float* cb = p.cos + (size_t)b * hd2;
    const float* sb = p.sin + (size_t)b * hd2;
    float rs = 0.f;
    if constexpr (kMode == W8A8) rs = __ldcg(p.asc + (size_t)ASC_LN1 * p.B + b);
    for (int i = 4 * c.tid; i < (group + 2) * HD; i += 4 * c.size) {
      // the group's query heads, then its K head, then its V head
      const int col = i < group * HD ? g * group * HD + i
                      : i < (group + 1) * HD ? QH + g * HD + (i - group * HD)
                                             : QH + KH + g * HD + (i - (group + 1) * HD);
      const float4 v = gemm_out4<kMode>(p, QKV, QO, b, col, sc, rs);
      qkv[i] = bf(v.x); qkv[i + 1] = bf(v.y); qkv[i + 2] = bf(v.z); qkv[i + 3] = bf(v.w);
    }
    c.sync();
    // x1 * c - x2 * s and x2 * c + x1 * s in f32, each product rounded
    for (int i = c.tid; i < (group + 1) * hd2; i += c.size) {
      const int head = i / hd2, e = i % hd2;
      const float x1 = qkv[head * HD + e], x2 = qkv[head * HD + e + hd2];
      const float cv = cb[e], sv = sb[e];
      const float o1 = __fsub_rn(__fmul_rn(x1, cv), __fmul_rn(x2, sv));
      const float o2 = __fadd_rn(__fmul_rn(x2, cv), __fmul_rn(x1, sv));
      if (head < group) {
        const size_t q = (size_t)b * QH + (size_t)(g * group + head) * HD + e;
        p.qbuf[q] = __float2bfloat16(o1);
        p.qbuf[q + hd2] = __float2bfloat16(o2);
      } else {
        kf[e] = bf(o1);
        kf[e + hd2] = bf(o2);
      }
    }
    for (int i = c.tid; i < HD; i += c.size) vf[i] = qkv[(group + 1) * HD + i];
    c.sync();
    float ak = 0.f, av = 0.f;
    for (int i = c.tid; i < HD; i += c.size) {
      ak = fmaxf(ak, fabsf(kf[i]));
      av = fmaxf(av, fabsf(vf[i]));
    }
    // the scale as a product with the f32 reciprocal of 127, the form in
    // which XLA evaluates the TPU kernel's quantizer; x / s stays a division
    const float sk = row_scale(block_max(ak, c, cs.red));
    const float sv = row_scale(block_max(av, c, cs.red));
    const size_t row = ((size_t)l * p.B + b) * KH + (size_t)g * HD;
    for (int i = c.tid; i < HD; i += c.size) {
      p.k_new[row + i] = code8(kf[i], sk);
      p.v_new[row + i] = code8(vf[i], sv);
    }
    if (c.tid == 0) {
      p.ks_new[((size_t)l * p.B + b) * p.HKV + g] = sk;
      p.vs_new[((size_t)l * p.B + b) * p.HKV + g] = sv;
    }
    c.sync();
  }
}

// Where request b's new K/V of kv head g in layer l land, if anywhere: the
// slot slot[b] of its cache row (K4, write_cache; read from device memory,
// so a captured launch writes where each replay's slots say), or its own
// write position
// in the pools (K8, in place; a stale length past the table (a retired row
// inside a horizon) stays inside the request's own table row, as JAX
// clamps).
template <bool kPaged>
static __device__ __forceinline__ bool new_kv_position(const Params& p, int l, int b, int g,
                                                       int8_t*& kw, int8_t*& vw, float*& ksw,
                                                       float*& vsw) {
  const int HD = p.HD, KH = p.HKV * HD;
  if (!p.write_cache) return false;
  if constexpr (kPaged) {
    const size_t page = (size_t)p.BS * KH, spage = (size_t)p.HKV * p.BS;
    const int len = p.q_slot[b];
    const size_t blk = (size_t)__ldg(p.tables + (size_t)b * p.MB + min(len / p.BS, p.MB - 1));
    const int off = len % p.BS;
    kw = p.kq + ((size_t)l * p.NB + blk) * 2 * page + (size_t)off * KH + (size_t)g * HD;
    vw = kw + page;
    ksw = p.ks + ((size_t)l * p.NB + blk) * 2 * spage + (size_t)g * p.BS + off;
    vsw = ksw + spage;
  } else {
    const int slot = p.slot[b];
    if (slot < 0 || slot >= p.S) return false;
    const size_t lb = (size_t)l * p.B + b;
    kw = p.kq + (lb * p.S + slot) * KH + (size_t)g * HD;
    vw = p.vq + (lb * p.S + slot) * KH + (size_t)g * HD;
    ksw = p.ks + (lb * p.HKV + g) * p.S + slot;
    vsw = p.vs + (lb * p.HKV + g) * p.S + slot;
  }
  return true;
}

// The cache writes of layer l, after every read of its attention phase: no
// item reads a position another writes in this launch. Per (request, kv
// head): the new K/V codes and scales from the new-KV buffers to their
// cache position.
template <bool kPaged>
static __device__ void new_kv_phase(const Params& p, const Crew& c, int l) {
  for (int it = c.id; it < p.B * p.HKV; it += c.count) {
    const int b = it / p.HKV, g = it % p.HKV;
    int8_t* kw; int8_t* vw; float* ksw; float* vsw;
    if (!new_kv_position<kPaged>(p, l, b, g, kw, vw, ksw, vsw)) continue;
    const size_t lb = (size_t)l * p.B + b, KH = (size_t)p.HKV * p.HD;
    const int8_t* kn = p.k_new + lb * KH + (size_t)g * p.HD;
    const int8_t* vn = p.v_new + lb * KH + (size_t)g * p.HD;
    for (int cc = c.tid; cc < p.HD; cc += c.size) {
      kw[cc] = __ldcg(kn + cc);
      vw[cc] = __ldcg(vn + cc);
    }
    if (c.tid == 0) {
      *ksw = __ldcg(p.ks_new + lb * p.HKV + g);
      *vsw = __ldcg(p.vs_new + lb * p.HKV + g);
    }
  }
}

// The cached keys request b attends (the current token aside).
template <bool kPaged>
static __device__ __forceinline__ int live_keys(const Params& p, int b) {
  if constexpr (kPaged) return min(p.q_slot[b], p.MB * p.BS);
  return max(0, min(p.q_slot[b] - 1, p.S - 1) - max(p.valid_from[b], 0) + 1);
}

// The attention order: order[i] is the request with the i-th most cached
// keys (ties in request order), B <= MAX_ORDER.
constexpr int MAX_ORDER = 256;
template <bool kPaged>
static __device__ void attention_order(const Params& p, short* order) {
  if (p.B > MAX_ORDER) return;
  for (int b = threadIdx.x; b < p.B; b += w8s::CONSUMERS) {
    const int keys = live_keys<kPaged>(p, b);
    int rank = 0;
    for (int u = 0; u < p.B; ++u) {
      const int ku = live_keys<kPaged>(p, u);
      rank += ku > keys || (ku == keys && u < b);
    }
    order[rank] = static_cast<short>(b);
  }
}

// Per (request, kv head): attention over the cache slots [valid_from,
// q_slot) (K8: the request's keys [0, lengths[b]) through its block table)
// merged with the current token, -> attn (bf16). The crews claim items one
// at a time from a counter, longest requests first (`order`): an item's
// length varies with its request, and a fixed share left some crews two
// long items, a claim in request order a long one last. An item is still
// computed by one crew alone, so the result does not depend on which.
template <bool kPaged>
static __device__ void attention_phase(const Params& p, const Crew& c, CrewSmem& cs, int l,
                                       const short* order) {
  using kv_attn::GMAX;
  kv_attn::Smem<int8_t>& sm = cs.att;
  const int HD = p.HD, group = p.HQ / p.HKV, items = p.B * p.HKV;
  const int QH = p.HQ * HD, KH = p.HKV * HD;
  const int tid = c.tid, lane = tid & 31, warp = tid >> 5;
  auto sync = [&c]() { c.sync(); };
  // every crew makes one claim past the last item, so layer l's claims
  // start at l * (items + crews)
  const int base = l * (items + c.count);
  for (;;) {
    if (tid == 0) cs.item = static_cast<int>(atomicAdd(p.sync + 1, 1u)) - base;
    c.sync();
    const int it = cs.item;
    if (it >= items) break;
    int b = it / p.HKV;
    const int g = it % p.HKV;
    if (p.B <= MAX_ORDER) b = order[b];
    const size_t lb = (size_t)l * p.B + b;
    const __nv_bfloat16* qg = p.qbuf + (size_t)b * QH + (size_t)g * group * HD;
    float acc[GMAX];
    if constexpr (kPaged) {
      const size_t page = (size_t)p.BS * KH, spage = (size_t)p.HKV * p.BS;
      const int8_t* kv = p.kq + (size_t)l * p.NB * 2 * page + (size_t)g * HD;
      const float* kvs = p.ks + (size_t)l * p.NB * 2 * spage + (size_t)g * p.BS;
      const int* table = p.tables + (size_t)b * p.MB;
      const kv_attn::PagedAddr addr{kv, kvs, table, p.BS, p.MB, (size_t)KH, page, spage};
      kv_attn::attend<true>(qg, addr, 0, min(p.q_slot[b], p.MB * p.BS) - 1, group, HD,
                            p.scale, sm, acc, tid, sync);
    } else {
      const int S = p.S;
      const kv_attn::SlotAddr addr{p.kq + lb * S * KH + (size_t)g * HD,
                                   p.vq + lb * S * KH + (size_t)g * HD,
                                   p.ks + (lb * p.HKV + g) * S, p.vs + (lb * p.HKV + g) * S,
                                   (size_t)KH};
      kv_attn::attend<true>(qg, addr, max(p.valid_from[b], 0),
                            min(p.q_slot[b] - 1, S - 1), group, HD, p.scale, sm, acc,
                            tid, sync);
    }
    // the current token, dequantized from the int8 values the cache will hold
    const int8_t* kn = p.k_new + lb * KH + (size_t)g * HD;
    const int8_t* vn = p.v_new + lb * KH + (size_t)g * HD;
    const float ksc = __ldcg(p.ks_new + lb * p.HKV + g);
    const float vsc = __ldcg(p.vs_new + lb * p.HKV + g);
    // HD <= 128: one 4-byte load of the key and one 8-byte load of q a lane
    const uint32_t kw4 = 4 * lane < HD ? __ldcg(reinterpret_cast<const unsigned*>(kn) + lane) : 0u;
    for (int r = warp; r < group; r += c.size / 32) {
      float dot = 0.f;
      if (4 * lane < HD) {
        const uint2 q4 = __ldcg(reinterpret_cast<const uint2*>(qg + r * HD + 4 * lane));
        const float qf[4] = {kv_attn::lo_f32(q4.x), kv_attn::hi_f32(q4.x),
                             kv_attn::lo_f32(q4.y), kv_attn::hi_f32(q4.y)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kq = static_cast<float>(static_cast<int8_t>(kw4 >> (8 * e)));
          dot += qf[e] * bf(kq * ksc);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const float s_cur = dot * p.scale;
        const float m_new = fmaxf(sm.m[r], s_cur);
        const float alpha = expf(sm.m[r] - m_new);
        const float p_cur = expf(s_cur - m_new);
        sm.alpha[r] = alpha;
        sm.pc[r] = p_cur;
        sm.l[r] = sm.l[r] * alpha + p_cur;
      }
    }
    c.sync();
    if (tid < HD) {
      const float v_cur = bf(static_cast<float>(__ldcg(vn + tid)) * vsc);
#pragma unroll
      for (int r = 0; r < GMAX; ++r) {
        if (r < group) {
          const float o = (acc[r] * sm.alpha[r] + sm.pc[r] * v_cur) / sm.l[r];
          p.attn[(size_t)b * QH + (size_t)(g * group + r) * HD + tid] = __float2bfloat16(o);
        }
      }
    }
    c.sync();
  }
}

// W8A8, per request on whole blocks: the bf16 attention row quantized into
// a8; and the silu row's absmax of this layer zeroed (silu_phase folds into
// it, three barriers later).
static __device__ void attn_quant_phase(const Params& p, const Crew& c, CrewSmem& cs) {
  const int QH = p.HQ * p.HD;
  for (int b = c.id; b < p.B; b += c.count) {
    const __nv_bfloat16* row = p.attn + (size_t)b * QH;
    quantize_row(p, c, cs.red, b, QH, p.asc + (size_t)ASC_ATTN * p.B + b,
                 [&](int i) { return kv_attn::ldcg_bf16(row + i); });
    if (c.tid == 0) p.asc[(size_t)ASC_FFMAX * p.B + b] = 0.f;
  }
}

// silu(bf16(gate)) * bf16(up) in f32 of the GU phase's outputs (b, n..n+3)
// and (b, F + n..F + n + 3).
template <int kMode>
static __device__ __forceinline__ float4 silu4(const Params& p, const float* sc, int b, int n,
                                               float rs) {
  const int F = p.F, N = 2 * F;
  const float4 g4 = gemm_out4<kMode>(p, GU, N, b, n, sc, rs);
  const float4 u4 = gemm_out4<kMode>(p, GU, N, b, F + n, sc, rs);
  const float gv[4] = {bf(g4.x), bf(g4.y), bf(g4.z), bf(g4.w)};
  const float uv[4] = {bf(u4.x), bf(u4.y), bf(u4.z), bf(u4.w)};
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = gv[e] / (1.f + expf(-gv[e])) * uv[e];
  return make_float4(o[0], o[1], o[2], o[3]);
}

// silu over the whole grid, four columns a consumer thread. W8A16, W4A16:
// ff = bf16(silu(gate) * up). W8A8, the first of two passes (its row
// absmax needs the whole row): each warp takes (request, 128 columns)
// items, writes the f32 values to ffs and folds their absmax into the
// row's with atomicMax on the float's bits (>= 0, so integer order is
// float order, and a max does not depend on the order of the arrivals).
template <int kMode>
static __device__ void silu_phase(const Params& p, int l) {
  const int F = p.F;
  const float* sc = p.sgu + (size_t)l * 2 * F;
  if constexpr (kMode == W8A8) {
    const int lane = threadIdx.x & 31, warps = gridDim.x * (w8s::CONSUMERS / 32);
    const int chunks = (F + 127) / 128;
    for (int it = blockIdx.x * (w8s::CONSUMERS / 32) + (threadIdx.x >> 5); it < p.B * chunks;
         it += warps) {
      const int b = it / chunks, n = (it % chunks) * 128 + 4 * lane;
      float amax = 0.f;
      if (n < F) {
        const float4 o = silu4<kMode>(p, sc, b, n, __ldcg(p.asc + (size_t)ASC_LN2 * p.B + b));
        *reinterpret_cast<float4*>(p.ffs + (size_t)b * F + n) = o;
        amax = fmaxf(fmaxf(fabsf(o.x), fabsf(o.y)), fmaxf(fabsf(o.z), fabsf(o.w)));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0)
        atomicMax(reinterpret_cast<int*>(p.asc + (size_t)ASC_FFMAX * p.B + b),
                  __float_as_int(amax));
    }
  } else {
    const int total = p.B * F;   // B * F < 2^31
    for (int i = 4 * (blockIdx.x * w8s::CONSUMERS + threadIdx.x); i < total;
         i += 4 * gridDim.x * w8s::CONSUMERS) {
      const float4 o = silu4<kMode>(p, sc, i / F, i % F, 0.f);
      stbf4(p.ff + i, o.x, o.y, o.z, o.w);
    }
  }
}

// W8A8, the second pass over the whole grid: the f32 silu row's int8 codes
// at its absmax's scale, four a consumer thread, into a8; the scale to
// asc[ASC_FF].
static __device__ void silu_quant_phase(const Params& p) {
  const int F = p.F, total = p.B * F;
  for (int i = 4 * (blockIdx.x * w8s::CONSUMERS + threadIdx.x); i < total;
       i += 4 * gridDim.x * w8s::CONSUMERS) {
    const int b = i / F, n = i % F;
    const float s = row_scale(__ldcg(p.asc + (size_t)ASC_FFMAX * p.B + b));
    const float4 v = ldcg4(p.ffs + i);
    const uint32_t q = static_cast<uint8_t>(code8(v.x, s)) |
                       static_cast<uint32_t>(static_cast<uint8_t>(code8(v.y, s))) << 8 |
                       static_cast<uint32_t>(static_cast<uint8_t>(code8(v.z, s))) << 16 |
                       static_cast<uint32_t>(static_cast<uint8_t>(code8(v.w, s))) << 24;
    *reinterpret_cast<uint32_t*>(p.a8 + (size_t)b * row_pitch(F) + n) = q;
    if (n == 0) p.asc[(size_t)ASC_FF * p.B + b] = s;
  }
}

// The tensor maps (w8a16_stream.cuh) of each GEMM phase: its weights, its
// activations (h, attn, h, ff; W8A8 a8 at each phase's width) and, W4A16,
// its group scales.
struct Maps {
  CUtensorMap w[4];
  CUtensorMap x[4];
  CUtensorMap s[4];
};

// The grid barrier, over the consumer threads only: the n-th barrier of a
// launch waits for the counter (zeroed before the launch) to reach n *
// gridDim.x.
static __device__ __forceinline__ void grid_sync(const Params& p, int& n) {
  w8s::consumers_sync();
  if (w8s::thread0()) {
    const unsigned target = static_cast<unsigned>(n + 1) * gridDim.x;
    unsigned count;
    __threadfence();
    asm volatile("atom.add.release.gpu.u32 %0, [%1], 1;\n"
                 : "=r"(count) : "l"(p.sync) : "memory");
    ++count;   // the count after this block's arrival
    for (unsigned long long since = 0; count < target;) {
      w8s::check_stuck(since);
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(count) : "l"(p.sync) : "memory");
    }
    __threadfence();
    stamp(p, n);
  }
  ++n;
  w8s::consumers_sync();
}

// One GEMM phase of layer l on the consumers: x (B, K) @ w[l] (K, N) into
// the workspace, from the stages the producers fill (W4A16: G rows a scale
// group, its totals in `crews`, which no phase uses across a barrier).
template <int kMode>
static __device__ __forceinline__ void gemm_phase(const Params& p, int l, int ph, int N, int G,
                                                  const CrewSmem* crews,
                                                  const w8s::Ring<kMode>& ring, uint32_t& it) {
  w8s::open_phase(ring, 4 * l + ph);
  if constexpr (kMode == W8A16) {
    w8s::consume_w8(p.plan[ph], p.ws, p.B, N, ring, it);
  } else if constexpr (kMode == W4A16) {
    w8s::consume_w4(p.plan[ph], p.ws, p.B, N, G, w8s::smem_u32(crews), ring, it);
  } else {
    w8s::consume_a8(p.plan[ph], reinterpret_cast<int*>(p.ws), p.B, N, ring, it);
  }
}

// The ring (1024-byte aligned), then the two crews' shared memory, then the
// attention order.
constexpr size_t RING_SPAN =
    (cmax(cmax(w8s::Geo<W8A16>::RING_BYTES, w8s::Geo<W4A16>::RING_BYTES),
          w8s::Geo<W8A8>::RING_BYTES) + 127) / 128 * 128;
constexpr size_t STREAM_SMEM =
    1024 + RING_SPAN + 2 * sizeof(CrewSmem) + MAX_ORDER * sizeof(short);
static_assert(STREAM_SMEM <= 232448, "over the H100's 227 KB a block");
static_assert(2 * sizeof(CrewSmem) >= w8s::CONSUMERS / 32 * w8s::TOT_WARP,
              "W4A16's totals fit in the crews' shared memory");

template <int kMode, bool kPaged>
__global__ void __launch_bounds__(w8s::THREADS, 1)
fused_decode_stream_kernel(const Params p, const __grid_constant__ Maps maps) {
  static_assert(!kPaged || kMode == W8A16, "K8 is W8A16, as the reference");
  extern __shared__ unsigned char dsmem[];
  const uint32_t raw = w8s::smem_u32(dsmem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const w8s::Ring<kMode> ring{base};
  CrewSmem* crews = reinterpret_cast<CrewSmem*>(dsmem + (base + RING_SPAN - raw));
  short* order = reinterpret_cast<short*>(crews + 2);
  if (w8s::thread0()) w8s::ring_init(ring);
  __syncthreads();

  const int D = p.D, F = p.F, QH = p.HQ * p.HD;
  const int QO = QH + 2 * p.HKV * p.HD;
  if (threadIdx.x >= w8s::CONSUMERS) {
    // the producers: every weight tile of this block, layer after layer,
    // and every x chunk, each once its phase is open
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(w8s::PRODUCER_REGS));
    const int N[4] = {QO, D, 2 * F, D};
    const int G[4] = {p.g_qkv, p.g_wo, p.g_gu, p.g_dn};
    uint32_t it = 0;
    if (threadIdx.x == w8s::CONSUMERS) {
      for (int l = 0; l < p.L; ++l)
#pragma unroll
        for (int ph = 0; ph < 4; ++ph)
          w8s::produce(p.plan[ph], &maps.w[ph], &maps.s[ph], l,
                       kMode == W4A16 ? N[ph] / 2 : N[ph], G[ph], ring, it);
    } else if (threadIdx.x == w8s::CONSUMERS + 32) {
      for (int l = 0; l < p.L; ++l)
#pragma unroll
        for (int ph = 0; ph < 4; ++ph)
          w8s::produce_x(p.plan[ph], &maps.x[ph], 4 * l + ph, ring, it);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(w8s::CONSUMER_REGS));
  // a half block's crew shared memory (crews[0] also the whole block's)
  auto cs = [crews]() -> CrewSmem& { return crews[w8s::tid_x() / CREW]; };
  uint32_t it = 0;   // ring stages consumed
  int n = 0;         // barriers passed
  attention_order<kPaged>(p, order);   // read after the first grid barrier
  rows_phase<kMode>(p, block_crew(), crews[0], nullptr, 0, 0, p.ln1, ASC_LN1, true);
  grid_sync(p, n);
  for (int l = 0; l < p.L; ++l) {
    gemm_phase(p, l, QKV, QO, p.g_qkv, crews, ring, it);
    grid_sync(p, n);
    qkv_phase<kMode>(p, half_crew(), cs(), l);
    grid_sync(p, n);
    attention_phase<kPaged>(p, half_crew(), cs(), l, order);
    grid_sync(p, n);
    if constexpr (kMode == W8A8) {
      attn_quant_phase(p, block_crew(), crews[0]);
      grid_sync(p, n);
    }
    gemm_phase(p, l, WO, D, p.g_wo, crews, ring, it);
    new_kv_phase<kPaged>(p, half_crew(), l);
    grid_sync(p, n);
    rows_phase<kMode>(p, block_crew(), crews[0], p.swo + (size_t)l * D, WO, ASC_ATTN,
                      p.ln2 + (size_t)l * D, ASC_LN2, false);
    grid_sync(p, n);
    gemm_phase(p, l, GU, 2 * F, p.g_gu, crews, ring, it);
    grid_sync(p, n);
    silu_phase<kMode>(p, l);
    grid_sync(p, n);
    if constexpr (kMode == W8A8) {
      silu_quant_phase(p);
      grid_sync(p, n);
    }
    gemm_phase(p, l, DN, D, p.g_dn, crews, ring, it);
    grid_sync(p, n);
    rows_phase<kMode>(p, block_crew(), crews[0], p.sdn + (size_t)l * D, DN, ASC_FF,
                      l + 1 < p.L ? p.ln1 + (size_t)(l + 1) * D : nullptr, ASC_LN1, false);
    if (l + 1 < p.L || p.clock != nullptr) grid_sync(p, n);
  }
}

// ---- host ------------------------------------------------------------------

// The kernel instances: 0-2 K4 in the modes W8A16, W4A16, W8A8; 3 K8.
constexpr int K8 = 3;

static const void* kernel_of(int instance) {
  switch (instance) {
    case W8A16: return reinterpret_cast<const void*>(&fused_decode_stream_kernel<W8A16, false>);
    case W4A16: return reinterpret_cast<const void*>(&fused_decode_stream_kernel<W4A16, false>);
    case W8A8: return reinterpret_cast<const void*>(&fused_decode_stream_kernel<W8A8, false>);
    case K8: return reinterpret_cast<const void*>(&fused_decode_stream_kernel<W8A16, true>);
    default: return nullptr;
  }
}

static cudaError_t prepare(int instance) {
  return cudaFuncSetAttribute(kernel_of(instance), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(STREAM_SMEM));
}

// plan: four GEMM phases x {the most partials of a column, tiles, blocks,
// k-tiles a slab, slabs}
static void set_plan(Params& p, const int* plan) {
  for (int ph = 0; ph < 4; ++ph) {
    const int* q = plan + 5 * ph;
    p.plan[ph] = w8s::Plan{q[1], q[2], q[3], q[4], q[0]};
  }
}

// The tensor maps of `mode`: weights (L, K, N) int8 or (L, K, N/2) packed,
// activations bf16 or, W8A8, the int8 rows of a8; W4A16 its group scales,
// as many rows a box as a stage holds groups.
static bool encode_maps(Maps& maps, const Params& p, int mode) {
  const int QH = p.HQ * p.HD, QO = QH + 2 * p.HKV * p.HD;
  const void* w[4] = {p.wqkv, p.wo, p.wgu, p.wdn};
  const float* s[4] = {p.sqkv, p.swo, p.sgu, p.sdn};
  const void* x[4] = {p.h, p.attn, p.h, p.ff};
  const int K[4] = {p.D, QH, p.D, p.F}, N[4] = {QO, p.D, 2 * p.F, p.D};
  const int G[4] = {p.g_qkv, p.g_wo, p.g_gu, p.g_dn};
  for (int ph = 0; ph < 4; ++ph) {
    const bool a8 = mode == W8A8, w4 = mode == W4A16;
    if (!w8s::encode_weights(&maps.w[ph], w[ph], p.L, K[ph], w4 ? N[ph] / 2 : N[ph]) ||
        !w8s::encode_x(&maps.x[ph], a8 ? p.a8 : x[ph], p.B, K[ph],
                       a8 ? row_pitch(K[ph]) : 2 * K[ph], a8))
      return false;
    if (w4 && !w8s::encode_scales(&maps.s[ph], s[ph], p.L, K[ph] / G[ph], N[ph],
                                  G[ph] < w8s::KT ? w8s::KT / G[ph] : 1))
      return false;
  }
  return true;
}

static int launch(Params& p, int instance, int mode, int grid, void* stream) {
  if (kernel_of(instance) == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(instance);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Maps maps;
  if (!encode_maps(maps, p, mode)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaMemsetAsync(p.sync, 0, 2 * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p, &maps};
  err = cudaLaunchCooperativeKernel(kernel_of(instance), dim3(grid), dim3(w8s::THREADS), args,
                                    STREAM_SMEM, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The weights, workspaces and outputs shared by K4 and K8.
static void set_common(Params& p, const void* x0, const void* ln1, const void* ln2,
                       const void* wqkv, const void* sqkv, const void* wo,
                       const void* swo, const void* wgu, const void* sgu,
                       const void* wdn, const void* sdn, const void* cos,
                       const void* sin, void* k_new, void* ks_new, void* v_new,
                       void* vs_new, void* x_out, void* xf, void* h, void* qbuf,
                       void* attn, void* ff, void* ws, void* sync, void* clock,
                       const int* plan) {
  p.x0 = static_cast<const __nv_bfloat16*>(x0);
  p.ln1 = static_cast<const __nv_bfloat16*>(ln1);
  p.ln2 = static_cast<const __nv_bfloat16*>(ln2);
  p.wqkv = static_cast<const int8_t*>(wqkv);
  p.sqkv = static_cast<const float*>(sqkv);
  p.wo = static_cast<const int8_t*>(wo);
  p.swo = static_cast<const float*>(swo);
  p.wgu = static_cast<const int8_t*>(wgu);
  p.sgu = static_cast<const float*>(sgu);
  p.wdn = static_cast<const int8_t*>(wdn);
  p.sdn = static_cast<const float*>(sdn);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.k_new = static_cast<int8_t*>(k_new);
  p.ks_new = static_cast<float*>(ks_new);
  p.v_new = static_cast<int8_t*>(v_new);
  p.vs_new = static_cast<float*>(vs_new);
  p.x_out = static_cast<__nv_bfloat16*>(x_out);
  p.xf = static_cast<float*>(xf);
  p.h = static_cast<__nv_bfloat16*>(h);
  p.qbuf = static_cast<__nv_bfloat16*>(qbuf);
  p.attn = static_cast<__nv_bfloat16*>(attn);
  p.ff = static_cast<__nv_bfloat16*>(ff);
  p.ws = static_cast<float*>(ws);
  p.sync = static_cast<unsigned*>(sync);
  p.clock = static_cast<unsigned long long*>(clock);
  set_plan(p, plan);
}

}  // namespace

// The grid of one launch of a kernel instance (kernel_of: 0-2 the K4 modes,
// 3 K8): SMs x resident blocks of that instance at its block size and
// dynamic shared memory (a cooperative launch needs the whole grid
// resident). Returns cudaSuccess or the error; an occupancy of zero is one.
extern "C" int pli_fused_decode_grid(int instance, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  *grid = 0;
  if (kernel_of(instance) == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = prepare(instance);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(instance),
                                                        w8s::THREADS, STREAM_SMEM);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  *grid = sms * per_sm;
  return static_cast<int>(err);
}

// K4 in `mode` (W8A16, W4A16 or W8A8). Every pointer is contiguous on one
// device in the layouts of Params; the int8 cache rows and weight rows are
// 16-byte aligned, HD % 16 == 0, HD <= 128, HQ / HKV <= 8, D % 16 == 0,
// F % 8 == 0 (W4A16: N/2 % 16 == 0 and group sizes g_* % 16 == 0) (checked
// by the Python wrapper). plan (host memory) holds, for each GEMM phase,
// {the most partials of a column, tiles, blocks, k-tiles a slab, slabs}
// (kernels/w8a16_stream.plan; W4A16 over the packed bytes); ws holds the
// largest phase's partials; sync two unsigned. W8A8: a8 holds B rows of
// row_pitch(max(D, HQ*HD, F)) bytes, asc 5 * B floats, ffs B * F floats.
// slot: with write_cache, (B,) int32 write slots on the device (a slot
// outside [0, S) writes nothing). clock: null, or 1 + L * phases stamps.
// `grid` comes from
// pli_fused_decode_grid(mode). Returns the launch's error.
extern "C" int pli_fused_decode_step(
    const void* x0, const void* ln1, const void* ln2, const void* wqkv,
    const void* sqkv, const void* wo, const void* swo, const void* wgu,
    const void* sgu, const void* wdn, const void* sdn, void* kq, void* ks,
    void* vq, void* vs, const void* cos, const void* sin, const void* q_slot,
    const void* valid_from, const void* slot, void* k_new, void* ks_new,
    void* v_new, void* vs_new, void* x_out, void* xf, void* h, void* qbuf,
    void* attn, void* ff, void* ws, void* a8, void* asc, void* ffs, void* sync,
    void* clock, const int* plan, int L, int B, int S, int D, int F, int HQ,
    int HKV, int HD, int write_cache, int mode, int g_qkv, int g_wo, int g_gu,
    int g_dn, float eps, float scale, int grid, void* stream) {
  if (mode != W8A16 && mode != W4A16 && mode != W8A8)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  set_common(p, x0, ln1, ln2, wqkv, sqkv, wo, swo, wgu, sgu, wdn, sdn, cos, sin,
             k_new, ks_new, v_new, vs_new, x_out, xf, h, qbuf, attn, ff, ws, sync,
             clock, plan);
  p.a8 = static_cast<int8_t*>(a8);
  p.asc = static_cast<float*>(asc);
  p.ffs = static_cast<float*>(ffs);
  p.g_qkv = g_qkv; p.g_wo = g_wo; p.g_gu = g_gu; p.g_dn = g_dn;
  p.kq = static_cast<int8_t*>(kq);
  p.ks = static_cast<float*>(ks);
  p.vq = static_cast<int8_t*>(vq);
  p.vs = static_cast<float*>(vs);
  p.tables = nullptr;
  p.q_slot = static_cast<const int*>(q_slot);
  p.valid_from = static_cast<const int*>(valid_from);
  p.L = L; p.B = B; p.S = S; p.D = D; p.F = F;
  p.HQ = HQ; p.HKV = HKV; p.HD = HD;
  p.NB = 0; p.MB = 0; p.BS = 0;
  p.slot = static_cast<const int*>(slot); p.write_cache = write_cache;
  p.eps = eps; p.scale = scale;
  return launch(p, mode, mode, grid, stream);
}

// K8. As K4 W8A16, with the merged pools kv (L, NB, 2, BS, HKV*HD) int8 and
// kvs (L, NB, 2, HKV, BS) f32, lengths (B,) >= 0 and tables (B, MB) int32
// whose entries are < NB; the pool rows are 16-byte aligned (HD % 16 == 0).
// inplace writes the new K/V into the pools. Returns the launch's error.
extern "C" int pli_fused_paged_decode_step(
    const void* x0, const void* ln1, const void* ln2, const void* wqkv,
    const void* sqkv, const void* wo, const void* swo, const void* wgu,
    const void* sgu, const void* wdn, const void* sdn, void* kv, void* kvs,
    const void* cos, const void* sin, const void* lengths, const void* tables,
    void* k_new, void* ks_new, void* v_new, void* vs_new, void* x_out,
    void* xf, void* h, void* qbuf, void* attn, void* ff, void* ws, void* sync,
    void* clock, const int* plan, int L, int B, int NB, int MB, int BS, int D,
    int F, int HQ, int HKV, int HD, int inplace, float eps, float scale,
    int grid, void* stream) {
  Params p;
  set_common(p, x0, ln1, ln2, wqkv, sqkv, wo, swo, wgu, sgu, wdn, sdn, cos, sin,
             k_new, ks_new, v_new, vs_new, x_out, xf, h, qbuf, attn, ff, ws, sync,
             clock, plan);
  p.a8 = nullptr;
  p.asc = nullptr;
  p.ffs = nullptr;
  p.g_qkv = p.g_wo = p.g_gu = p.g_dn = 0;
  p.kq = static_cast<int8_t*>(kv);
  p.ks = static_cast<float*>(kvs);
  p.vq = nullptr;
  p.vs = nullptr;
  p.tables = static_cast<const int*>(tables);
  p.q_slot = static_cast<const int*>(lengths);
  p.valid_from = nullptr;
  p.L = L; p.B = B; p.S = 0; p.D = D; p.F = F;
  p.HQ = HQ; p.HKV = HKV; p.HD = HD;
  p.NB = NB; p.MB = MB; p.BS = BS;
  p.slot = nullptr; p.write_cache = inplace;
  p.eps = eps; p.scale = scale;
  return launch(p, K8, W8A16, grid, stream);
}
