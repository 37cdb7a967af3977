// K4 and K8: the whole INT8-KV decode step for all layers, in one launch.
//
// K4 replaces the TPU kernel physics_llm_inference_tpu/kernels/
// fused_decode.py (fused_decode_step -> _kernel) in its three modes, each an
// instance of fused_decode_kernel<false, kMode> (the mode is a template
// parameter; no inner loop branches on it at run time):
//  - W8A16, the default (K-blocked weight tiles, silu per DOWN tile, bf16
//    activations): the W8A16 tile, f32 K-split partials, the per-channel
//    scale after their sum;
//  - W4A16: nibble-packed INT4 weights with group scales (w4a16_tile.cuh).
//    A work item reads each packed byte once and makes both output columns
//    it holds (j and N/2 + j); its K range is whole scale groups, and each
//    group's f32 partial is scaled by the group's scale row and added in K
//    order in registers (the TPU kernel's `acc += part * s` per K-tile), so
//    the f32 workspace receives scaled partials;
//  - W8A8 (act_quant = "int8"): each activation row is quantized to int8
//    over its absmax after ln1, after attention (one more phase and barrier
//    a layer), after ln2 and after silu (a per-request phase), into `a8`
//    with its scale in `asc`; the int8 x int8 tile (w8a8_tile.cuh)
//    accumulates exact int32 K-split partials, summed as integers, then
//    (f32(sum) * row_scale) * w_scale.
// K8 replaces
// fused_paged_decode_step -> _paged_kernel_r5 of the same file: the same
// kernel with a paged address mode in the attention phase only (the
// fused_decode_kernel<true> instance). Its KV lives in the merged INT8 block
// pools (L, NB, 2, BS, Hkv*d) / (L, NB, 2, Hkv, BS) f32 reached through the
// block table; request b attends its keys [0, lengths[b]) plus the current
// token and, in place, writes the new codes and scales at position
// lengths[b] of block tables[b, min(lengths[b] / BS, MB - 1)], after that
// item's own reads. Of the TPU kernel's machinery (request groups, rotating
// value rings, the layer-resident scale copy, DMA semaphores, 8-slot write
// windows) nothing is needed here: a pool row is addressed directly. Per layer: RMSNorm,
// QKV, RoPE, KV quantize and write, attention over the INT8 cache plus the
// current token, WO, RMSNorm, gate/up, silu * up, down. The numerics are the
// TPU kernel's: the residual stream stays f32 across all layers and is cast
// to bf16 once at the end; qkv, gate and up are rounded to bf16 after their
// f32 sums; K is rounded to bf16 after RoPE and quantized per head; the
// current token attends through the dequantized int8 values the cache will
// hold; p * v_scale is rounded to bf16 before P@V.
//
// Bound on the H100: weight bytes (at B = 64 every int8 weight byte feeds 128
// operations, every packed INT4 byte 256, far below the ~295 flop/byte bf16
// and ~590 op/byte int8 ridges) plus the live KV bytes. The TPU
// kernel keeps activations in VMEM and walks one sequential grid; here one
// persistent cooperative launch covers the step (grid = SMs x resident
// blocks), and the phases of a layer are separated by grid-wide barriers.
// Each phase walks a flat list of work items with a grid-stride loop:
//   1. QKV partials: (m-tile, n-tile, k-split) items of the W8A16 tile
//      (w8a16_tile.cuh); K is split so that N = 6144 still fills the card;
//   2. per (request, kv head): fixed-order sum of the partials, bf16, RoPE,
//      quantize K/V into the new-KV buffers;
//   3. per (request, kv head): attention over the cache slots
//      [valid_from, q_slot) (kv_attn::attend, shared with K2; K8: the
//      request's pool blocks through the table), merged with the current
//      token, then the in-place cache write at `slot` (K8: the request's
//      own write position) after this item's own reads of that cache row;
//   4. WO partials;  5. per request: x += sum * scale, then RMSNorm -> h;
//   6. gate/up partials;  7. silu(gate) * up -> ff;
//   8. DOWN partials;  9. per request: x += sum * scale, then the next
//      layer's RMSNorm (or the bf16 output after the last layer).
// Partials go to an f32 workspace and are summed in a fixed order (no float
// atomics), so the step is deterministic. L1 is not coherent across SMs, so
// everything another block wrote in this launch is read with ld.global.cg.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_kv_attention.cuh"
#include "w4a16_tile.cuh"
#include "w8a16_tile.cuh"
#include "w8a8_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
static_assert(THREADS == w8a16::THREADS && THREADS == kv_attn::THREADS &&
                  THREADS == w8a8::THREADS,
              "the phases share one block shape");
constexpr int NWARPS = THREADS / 32;
constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
constexpr size_t SMEM_BYTES =
    cmax(cmax(sizeof(w8a16::Smem), sizeof(kv_attn::Smem)),
         cmax(sizeof(w4a16::Smem), sizeof(w8a8::Smem)));

// The K4 modes (kernels/fused_decode.py numbers them alike).
constexpr int W8A16 = 0, W4A16 = 1, W8A8 = 2;
// W8A8: the rows of `asc`, one per activation quantization point.
constexpr int ASC_LN1 = 0, ASC_ATTN = 1, ASC_LN2 = 2, ASC_FF = 3;

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
  float* ws;                               // (splits, B, N) f32 partials
                                           // (W8A8: int32)
  int8_t* a8;                              // W8A8: (B, K) int8 activation rows
  float* asc;                              // W8A8: (4, B) their scales
  int L, B, S, D, F, HQ, HKV, HD;
  int NB, MB, BS;                          // K8: pool blocks, table width, block size
  int slot, write_cache;
  int split_qkv, split_wo, split_gu, split_dn;
  int g_qkv, g_wo, g_gu, g_dn;             // W4A16: K rows of a scale group
  float eps, scale;
};

static __device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) t += red[w];
  __syncthreads();
  return t;
}

static __device__ __forceinline__ double block_sum_d(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) t += red[w];
  __syncthreads();
  return t;
}

static __device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) t = fmaxf(t, red[w]);
  __syncthreads();
  return t;
}

static __device__ __forceinline__ float bf(float x) { return kv_attn::round_bf16(x); }

// Sum of the k-split partials of output (b, n), in split order.
static __device__ __forceinline__ float partial_sum(const float* ws, int splits,
                                                    int B, int N, int b, int n) {
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += __ldcg(ws + ((size_t)s * B + b) * N + n);
  return acc;
}

// Int32 sum of the W8A8 k-split partials of output (b, n).
static __device__ __forceinline__ int partial_isum(const float* ws, int splits,
                                                  int B, int N, int b, int n) {
  const int* wi = reinterpret_cast<const int*>(ws);
  int acc = 0;
  for (int s = 0; s < splits; ++s) acc += __ldcg(wi + ((size_t)s * B + b) * N + n);
  return acc;
}

// Output (b, n) of a GEMM phase from its partials: W8A16 sum * scale[n];
// W4A16 the sum (the partials carry their group scales); W8A8
// (f32(integer sum) * rs) * scale[n], rs the input row's scale.
template <int kMode>
static __device__ __forceinline__ float gemm_out(const Params& p, int splits, int N,
                                                 int b, int n, const float* scale,
                                                 float rs) {
  if constexpr (kMode == W8A16) {
    return partial_sum(p.ws, splits, p.B, N, b, n) * scale[n];
  } else if constexpr (kMode == W4A16) {
    return partial_sum(p.ws, splits, p.B, N, b, n);
  } else {
    return static_cast<float>(partial_isum(p.ws, splits, p.B, N, b, n)) * rs * scale[n];
  }
}

// ws[split, m, n] = sum over the split's K range of x[m, k] * w[k, n]
// (unscaled), for x (M, K) bf16 and w (K, N) int8.
static __device__ void gemm_partials(const __nv_bfloat16* x, const int8_t* w,
                                     float* ws, int M, int N, int K, int splits,
                                     w8a16::Smem& sm) {
  using namespace w8a16;
  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  const int per = ((K + BK - 1) / BK + splits - 1) / splits;  // k-tiles per split
  const int items = mt * nt * splits;
  const bool vec_x = K % 8 == 0, vec_w = N % 16 == 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int split = it % splits, tile = it / splits;
    const int n0 = (tile % nt) * BN, m0 = (tile / nt) * BM;
    const int k_begin = split * per * BK;
    const int k_end = min(K, k_begin + per * BK);
    tile_gemm(x, w, M, N, K, k_begin, k_end, m0, n0, vec_x, vec_w, sm);
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN, gm = m0 + r, gn = n0 + c;
      if (gm < M && gn < N) ws[((size_t)split * M + gm) * N + gn] = sm.c[r * CS_LD + c];
    }
    __syncthreads();
  }
}

// W4A16: ws[split, m, n] = sum over the split's scale groups g, in K order,
// of s[g, n] * (x[m, g*G:(g+1)*G] @ w[g*G:(g+1)*G, n]), for x (M, K) bf16, w
// the packed (K, N/2) bytes and s the (K/G, N) group scales. An item is one
// m-tile, packed columns [j0, j0 + 64) (output columns j0 + c and N/2 + j0 +
// c) and one split; thread t owns column t of the 64 x 128 result and keeps
// its 64 rows in registers across the split's groups.
static __device__ void gemm_partials_w4(const __nv_bfloat16* x, const int8_t* w,
                                        const float* s, float* ws, int M, int N,
                                        int K, int G, int splits, w4a16::Smem& sm) {
  using namespace w4a16;
  static_assert(THREADS == 2 * BN, "a thread per column of the two halves");
  const int NH = N / 2;
  const int mt = (M + BM - 1) / BM, nt = (NH + BN - 1) / BN;
  const int groups = K / G;
  const int per = (groups + splits - 1) / splits;  // groups per split
  const int items = mt * nt * splits;
  const bool vec_x = K % 8 == 0, vec_w = NH % 16 == 0;
  const int c = threadIdx.x;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int split = it % splits, tile = it / splits;
    const int n0 = (tile % nt) * BN, m0 = (tile / nt) * BM;
    const int j = n0 + (c < BN ? c : c - BN);         // packed column
    const bool live = j < NH;
    const int col = c < BN ? j : NH + j;              // output column
    float acc[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = 0.f;
    const int g_end = min(groups, (split + 1) * per);
    for (int g = split * per; g < g_end; ++g) {
      tile_gemm(x, w, M, NH, K, g * G, (g + 1) * G, m0, n0, vec_x, vec_w, sm);
      const float sg = live ? __ldg(s + (size_t)g * N + col) : 0.f;
      const float* cs = sm.c();
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] += cs[r * CS_LD + c] * sg;
      __syncthreads();
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < BM; ++r)
        if (m0 + r < M) ws[((size_t)split * M + m0 + r) * N + col] = acc[r];
    }
  }
}

// W8A8: ws[split, m, n] = the int32 sum over the split's K range of
// x[m, k] * w[k, n], for x (M, K) and w (K, N) int8.
static __device__ void gemm_partials_a8(const int8_t* x, const int8_t* w, int* ws,
                                        int M, int N, int K, int splits,
                                        w8a8::Smem& sm) {
  using namespace w8a8;
  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  const int per = ((K + BK - 1) / BK + splits - 1) / splits;  // k-tiles per split
  const int items = mt * nt * splits;
  const bool vec_x = K % 16 == 0, vec_w = N % 16 == 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int split = it % splits, tile = it / splits;
    const int n0 = (tile % nt) * BN, m0 = (tile / nt) * BM;
    const int k_begin = split * per * BK;
    const int k_end = min(K, k_begin + per * BK);
    tile_gemm(x, w, M, N, K, k_begin, k_end, m0, n0, vec_x, vec_w, sm);
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN, gm = m0 + r, gn = n0 + c;
      if (gm < M && gn < N) ws[((size_t)split * M + gm) * N + gn] = sm.c[r * CS_LD + c];
    }
    __syncthreads();
  }
}

// W8A8: row b of width n, value(i) in f32, to int8 codes a8[b * n + i] =
// clip(rint(value(i) / s), +-127) with s = max(absmax, 1e-8) * (1/127) (the
// scale in the form XLA gives the TPU kernel's `_qrow`), s to *scale_out.
template <class Value>
static __device__ void quantize_row(const Params& p, int b, int n, float* scale_out,
                                    Value value, float* red) {
  float amax = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) amax = fmaxf(amax, fabsf(value(i)));
  const float s = fmaxf(block_max(amax, red), 1e-8f) * (1.f / 127.f);
  int8_t* row = p.a8 + (size_t)b * n;
  for (int i = threadIdx.x; i < n; i += THREADS)
    row[i] = static_cast<int8_t>(fminf(fmaxf(rintf(value(i) / s), -127.f), 127.f));
  if (threadIdx.x == 0) *scale_out = s;
}

// Per request b: x = x0 (init) or x += the GEMM phase's output (its
// partials, `scale`, and for W8A8 the input row scale asc[in_row]); then
// h = bf16(rms(x) * ln) when ln is given, else x_out = bf16(x). W8A8: the
// f32 rms(x) * ln is quantized into a8, its scale to asc[out_row]; the
// mean of squares is summed in f64 and rounded once, and 1 / sqrtf is
// IEEE, as the plain version's `_rms_exact`: the row is not rounded to bf16
// before its codes, so its last bit decides codes at exact .5 ties.
template <int kMode>
static __device__ void rows_phase(const Params& p, const float* scale, int splits,
                                  int in_row, const __nv_bfloat16* ln, int out_row,
                                  bool init, float* red) {
  const int D = p.D;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    float* xr = p.xf + (size_t)b * D;
    float rs = 0.f;
    if constexpr (kMode == W8A8) {
      if (!init) rs = __ldcg(p.asc + (size_t)in_row * p.B + b);
    }
    float ss = 0.f;
    double ss_d = 0.0;
    for (int n = threadIdx.x; n < D; n += THREADS) {
      float x;
      if (init) {
        x = __bfloat162float(p.x0[(size_t)b * D + n]);
      } else {
        x = __ldcg(xr + n) + gemm_out<kMode>(p, splits, D, b, n, scale, rs);
      }
      xr[n] = x;
      if constexpr (kMode == W8A8) {
        ss_d += static_cast<double>(x) * x;
      } else {
        ss += x * x;
      }
    }
    if (ln != nullptr) {
      if constexpr (kMode == W8A8) {
        __shared__ double red_d[NWARPS];
        const float ms = static_cast<float>(block_sum_d(ss_d, red_d) / D);
        const float r = 1.f / sqrtf(ms + p.eps);
        quantize_row(p, b, D, p.asc + (size_t)out_row * p.B + b,
                     [&](int n) { return __ldcg(xr + n) * r * __bfloat162float(ln[n]); },
                     red);
      } else {
        const float tot = block_sum(ss, red);
        const float r = 1.f / sqrtf(tot / D + p.eps);
        for (int n = threadIdx.x; n < D; n += THREADS) {
          p.h[(size_t)b * D + n] =
              __float2bfloat16(__ldcg(xr + n) * r * __bfloat162float(ln[n]));
        }
      }
    } else {
      for (int n = threadIdx.x; n < D; n += THREADS)
        p.x_out[(size_t)b * D + n] = __float2bfloat16(__ldcg(xr + n));
    }
    __syncthreads();
  }
}

// Per (request, kv head): qkv = bf16(the QKV phase's output); RoPE on the
// group's query heads -> qbuf (bf16); K rotated and rounded to bf16, V as
// is; both quantized per head (absmax / 127, round half to even, clip +-127)
// into the new-KV buffers of layer l.
template <int kMode>
static __device__ void qkv_phase(const Params& p, int l, float* red, float* kv_sm) {
  const int HD = p.HD, hd2 = HD / 2, group = p.HQ / p.HKV;
  const int QH = p.HQ * HD, KH = p.HKV * HD, QO = QH + 2 * KH;
  const float* sc = p.sqkv + (size_t)l * QO;
  float* kf = kv_sm;
  float* vf = kv_sm + HD;
  for (int it = blockIdx.x; it < p.B * p.HKV; it += gridDim.x) {
    const int b = it / p.HKV, g = it % p.HKV;
    const float* cs = p.cos + (size_t)b * hd2;
    const float* sn = p.sin + (size_t)b * hd2;
    float rs = 0.f;
    if constexpr (kMode == W8A8) rs = __ldcg(p.asc + (size_t)ASC_LN1 * p.B + b);
    auto val = [&](int n) { return bf(gemm_out<kMode>(p, p.split_qkv, QO, b, n, sc, rs)); };
    for (int i = threadIdx.x; i < group * hd2; i += THREADS) {
      const int col = (g * group + i / hd2) * HD + i % hd2;
      const float x1 = val(col), x2 = val(col + hd2);
      const float c = cs[i % hd2], s = sn[i % hd2];
      p.qbuf[(size_t)b * QH + col] =
          __float2bfloat16(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
      p.qbuf[(size_t)b * QH + col + hd2] =
          __float2bfloat16(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
    }
    for (int i = threadIdx.x; i < hd2; i += THREADS) {
      const int col = QH + g * HD + i;
      const float x1 = val(col), x2 = val(col + hd2);
      kf[i] = bf(__fsub_rn(__fmul_rn(x1, cs[i]), __fmul_rn(x2, sn[i])));
      kf[i + hd2] = bf(__fadd_rn(__fmul_rn(x2, cs[i]), __fmul_rn(x1, sn[i])));
    }
    for (int i = threadIdx.x; i < HD; i += THREADS) vf[i] = val(QH + KH + g * HD + i);
    __syncthreads();
    float ak = 0.f, av = 0.f;
    for (int i = threadIdx.x; i < HD; i += THREADS) {
      ak = fmaxf(ak, fabsf(kf[i]));
      av = fmaxf(av, fabsf(vf[i]));
    }
    // the scale as a product with the f32 reciprocal of 127, the form in
    // which XLA evaluates the TPU kernel's quantizer; x / s stays a division
    const float sk = fmaxf(block_max(ak, red), 1e-8f) * (1.f / 127.f);
    const float sv = fmaxf(block_max(av, red), 1e-8f) * (1.f / 127.f);
    const size_t row = ((size_t)l * p.B + b) * KH + (size_t)g * HD;
    for (int i = threadIdx.x; i < HD; i += THREADS) {
      p.k_new[row + i] = static_cast<int8_t>(fminf(fmaxf(rintf(kf[i] / sk), -127.f), 127.f));
      p.v_new[row + i] = static_cast<int8_t>(fminf(fmaxf(rintf(vf[i] / sv), -127.f), 127.f));
    }
    if (threadIdx.x == 0) {
      p.ks_new[((size_t)l * p.B + b) * p.HKV + g] = sk;
      p.vs_new[((size_t)l * p.B + b) * p.HKV + g] = sv;
    }
    __syncthreads();
  }
}

// Per (request, kv head): attention over the cache slots [valid_from,
// q_slot) (K8: the request's keys [0, lengths[b]) through its block table)
// merged with the current token, -> attn (bf16); then, with write_cache,
// the new K/V land at `slot` of this cache row (K8: at the request's own
// write position).
template <bool kPaged>
static __device__ void attention_phase(const Params& p, int l, kv_attn::Smem& sm) {
  using kv_attn::GMAX;
  const int HD = p.HD, group = p.HQ / p.HKV;
  const int QH = p.HQ * HD, KH = p.HKV * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int it = blockIdx.x; it < p.B * p.HKV; it += gridDim.x) {
    const int b = it / p.HKV, g = it % p.HKV;
    const size_t lb = (size_t)l * p.B + b;
    const __nv_bfloat16* qg = p.qbuf + (size_t)b * QH + (size_t)g * group * HD;
    float acc[GMAX];
    bool write = false;
    int8_t* kw = nullptr;   // this item's write position: K, V codes, scales
    int8_t* vw = nullptr;
    float* ksw = nullptr;
    float* vsw = nullptr;
    if constexpr (kPaged) {
      const size_t page = (size_t)p.BS * KH, spage = (size_t)p.HKV * p.BS;
      int8_t* kv = p.kq + (size_t)l * p.NB * 2 * page + (size_t)g * HD;
      float* kvs = p.ks + (size_t)l * p.NB * 2 * spage + (size_t)g * p.BS;
      const int* table = p.tables + (size_t)b * p.MB;
      const kv_attn::PagedAddr addr{kv, kvs, table, p.BS, p.MB, (size_t)KH, page, spage};
      const int len = p.q_slot[b];
      kv_attn::attend<true>(qg, addr, 0, min(len, p.MB * p.BS) - 1, group, HD,
                            p.scale, sm, acc);
      if (p.write_cache) {
        // a stale length past the table (a retired row inside a horizon)
        // stays inside the request's own table row, as JAX clamps
        const size_t blk = (size_t)__ldg(table + min(len / p.BS, p.MB - 1));
        const int off = len % p.BS;
        write = true;
        kw = kv + blk * 2 * page + (size_t)off * KH;
        vw = kw + page;
        ksw = kvs + blk * 2 * spage + off;
        vsw = ksw + spage;
      }
    } else {
      const int S = p.S;
      int8_t* kbase = p.kq + lb * S * KH + (size_t)g * HD;
      int8_t* vbase = p.vq + lb * S * KH + (size_t)g * HD;
      float* ksb = p.ks + (lb * p.HKV + g) * S;
      float* vsb = p.vs + (lb * p.HKV + g) * S;
      const kv_attn::SlotAddr addr{kbase, vbase, ksb, vsb, (size_t)KH};
      kv_attn::attend<true>(qg, addr, max(p.valid_from[b], 0),
                            min(p.q_slot[b] - 1, S - 1), group, HD, p.scale, sm, acc);
      if (p.write_cache && p.slot >= 0 && p.slot < S) {
        write = true;
        kw = kbase + (size_t)p.slot * KH;
        vw = vbase + (size_t)p.slot * KH;
        ksw = ksb + p.slot;
        vsw = vsb + p.slot;
      }
    }

    // the current token, dequantized from the int8 values the cache holds
    const int8_t* kn = p.k_new + lb * KH + (size_t)g * HD;
    const int8_t* vn = p.v_new + lb * KH + (size_t)g * HD;
    const float ksc = __ldcg(p.ks_new + lb * p.HKV + g);
    const float vsc = __ldcg(p.vs_new + lb * p.HKV + g);
    for (int r = warp; r < group; r += NWARPS) {
      float dot = 0.f;
      for (int c = lane; c < HD; c += 32)
        dot += sm.q[r][c] * bf(static_cast<float>(__ldcg(kn + c)) * ksc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const float s_cur = dot * p.scale;
        const float m_new = fmaxf(sm.m[r], s_cur);
        const float alpha = expf(sm.m[r] - m_new);
        const float p_cur = expf(s_cur - m_new);
        sm.alpha[r] = alpha;
        sm.p[r][0] = p_cur;
        sm.l[r] = sm.l[r] * alpha + p_cur;
      }
    }
    __syncthreads();
    if (tid < HD) {
      const float v_cur = bf(static_cast<float>(__ldcg(vn + tid)) * vsc);
#pragma unroll
      for (int r = 0; r < GMAX; ++r) {
        if (r < group) {
          const float o = (acc[r] * sm.alpha[r] + sm.p[r][0] * v_cur) / sm.l[r];
          p.attn[(size_t)b * QH + (size_t)(g * group + r) * HD + tid] = __float2bfloat16(o);
        }
      }
    }
    if (write) {
      for (int c = tid; c < HD; c += THREADS) {
        kw[c] = __ldcg(kn + c);
        vw[c] = __ldcg(vn + c);
      }
      if (tid == 0) {
        *ksw = ksc;
        *vsw = vsc;
      }
    }
    __syncthreads();
  }
}

// W8A8, per request: the bf16 attention row quantized into a8.
static __device__ void attn_quant_phase(const Params& p, float* red) {
  const int QH = p.HQ * p.HD;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const __nv_bfloat16* row = p.attn + (size_t)b * QH;
    quantize_row(p, b, QH, p.asc + (size_t)ASC_ATTN * p.B + b,
                 [&](int i) { return kv_attn::ldcg_bf16(row + i); }, red);
  }
}

// ff = bf16(silu(bf16(gate)) * bf16(up)), gate/up = the GU phase's output.
// W8A8: per request, the f32 silu(gate) * up row quantized into a8 (its
// absmax needs the whole row).
template <int kMode>
static __device__ void silu_phase(const Params& p, int l, float* red) {
  const int F = p.F, N = 2 * F;
  const float* sc = p.sgu + (size_t)l * N;
  if constexpr (kMode == W8A8) {
    for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
      const float rs = __ldcg(p.asc + (size_t)ASC_LN2 * p.B + b);
      auto ff = [&](int n) {
        const float gate = bf(gemm_out<kMode>(p, p.split_gu, N, b, n, sc, rs));
        const float up = bf(gemm_out<kMode>(p, p.split_gu, N, b, F + n, sc, rs));
        return gate / (1.f + expf(-gate)) * up;
      };
      quantize_row(p, b, F, p.asc + (size_t)ASC_FF * p.B + b, ff, red);
    }
  } else {
    const size_t total = (size_t)p.B * F;
    for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
         i += (size_t)gridDim.x * THREADS) {
      const int b = static_cast<int>(i / F), n = static_cast<int>(i % F);
      const float gate = bf(gemm_out<kMode>(p, p.split_gu, N, b, n, sc, 0.f));
      const float up = bf(gemm_out<kMode>(p, p.split_gu, N, b, F + n, sc, 0.f));
      p.ff[i] = __float2bfloat16(gate / (1.f + expf(-gate)) * up);
    }
  }
}

// One GEMM phase of layer l: x (B, K) @ w[l] (K, N) into the workspace.
// W8A16: x bf16, f32 partials; W4A16: x bf16, w the packed bytes, s the
// group scales, G rows a group, scaled f32 partials; W8A8: x the int8 rows
// of a8, int32 partials.
template <int kMode>
static __device__ void gemm_phase(const Params& p, const __nv_bfloat16* x,
                                  const int8_t* w, const float* s, int l, int N,
                                  int K, int G, int splits, unsigned char* smem) {
  if constexpr (kMode == W8A16) {
    gemm_partials(x, w + (size_t)l * K * N, p.ws, p.B, N, K, splits,
                  *reinterpret_cast<w8a16::Smem*>(smem));
  } else if constexpr (kMode == W4A16) {
    gemm_partials_w4(x, w + (size_t)l * K * (N / 2), s + (size_t)l * (K / G) * N,
                     p.ws, p.B, N, K, G, splits, *reinterpret_cast<w4a16::Smem*>(smem));
  } else {
    gemm_partials_a8(p.a8, w + (size_t)l * K * N, reinterpret_cast<int*>(p.ws), p.B, N,
                     K, splits, *reinterpret_cast<w8a8::Smem*>(smem));
  }
}

template <bool kPaged, int kMode = W8A16>
__global__ void __launch_bounds__(THREADS) fused_decode_kernel(Params p) {
  __shared__ __align__(128) unsigned char smem_raw[SMEM_BYTES];
  __shared__ float red[NWARPS];
  __shared__ float kv_sm[2 * kv_attn::DMAX];
  kv_attn::Smem& att = *reinterpret_cast<kv_attn::Smem*>(smem_raw);
  cg::grid_group grid = cg::this_grid();

  const int D = p.D, F = p.F, QH = p.HQ * p.HD;
  const int QO = QH + 2 * p.HKV * p.HD;
  rows_phase<kMode>(p, nullptr, 0, 0, p.ln1, ASC_LN1, true, red);
  grid.sync();
  for (int l = 0; l < p.L; ++l) {
    gemm_phase<kMode>(p, p.h, p.wqkv, p.sqkv, l, QO, D, p.g_qkv, p.split_qkv, smem_raw);
    grid.sync();
    qkv_phase<kMode>(p, l, red, kv_sm);
    grid.sync();
    attention_phase<kPaged>(p, l, att);
    grid.sync();
    if constexpr (kMode == W8A8) {
      attn_quant_phase(p, red);
      grid.sync();
    }
    gemm_phase<kMode>(p, p.attn, p.wo, p.swo, l, D, QH, p.g_wo, p.split_wo, smem_raw);
    grid.sync();
    rows_phase<kMode>(p, p.swo + (size_t)l * D, p.split_wo, ASC_ATTN,
                      p.ln2 + (size_t)l * D, ASC_LN2, false, red);
    grid.sync();
    gemm_phase<kMode>(p, p.h, p.wgu, p.sgu, l, 2 * F, D, p.g_gu, p.split_gu, smem_raw);
    grid.sync();
    silu_phase<kMode>(p, l, red);
    grid.sync();
    gemm_phase<kMode>(p, p.ff, p.wdn, p.sdn, l, D, F, p.g_dn, p.split_dn, smem_raw);
    grid.sync();
    rows_phase<kMode>(p, p.sdn + (size_t)l * D, p.split_dn, ASC_FF,
                      l + 1 < p.L ? p.ln1 + (size_t)(l + 1) * D : nullptr, ASC_LN1,
                      false, red);
    if (l + 1 < p.L) grid.sync();
  }
}

// The kernel instances: 0-2 K4 in the modes W8A16, W4A16, W8A8; 3 K8.
static const void* kernel_of(int instance) {
  switch (instance) {
    case W8A16: return reinterpret_cast<const void*>(&fused_decode_kernel<false, W8A16>);
    case W4A16: return reinterpret_cast<const void*>(&fused_decode_kernel<false, W4A16>);
    case W8A8: return reinterpret_cast<const void*>(&fused_decode_kernel<false, W8A8>);
    case 3: return reinterpret_cast<const void*>(&fused_decode_kernel<true, W8A16>);
    default: return nullptr;
  }
}

static int launch(Params& p, int instance, int grid, void* stream) {
  if (kernel_of(instance) == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel_of(instance), dim3(grid),
                                                dim3(THREADS), args, 0,
                                                static_cast<cudaStream_t>(stream));
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
                       void* attn, void* ff, void* ws) {
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
}

}  // namespace

// The grid of one launch of a kernel instance (kernel_of: 0-2 the K4 modes,
// 3 K8): SMs x resident blocks of that instance (a cooperative launch needs
// the whole grid resident). Returns cudaSuccess or the error.
extern "C" int pli_fused_decode_grid(int instance, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  if (kernel_of(instance) == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(instance),
                                                        THREADS, 0);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  *grid = sms * per_sm;
  return static_cast<int>(err);
}

// K4 in `mode` (W8A16, W4A16 or W8A8). Every pointer is contiguous on one
// device in the layouts of Params; the int8 cache rows and weight rows are
// 16-byte aligned (W4A16: N/2 % 16 == 0), HD % 16 == 0, HD <= 128,
// HQ / HKV <= 8 (checked by the Python wrapper). splits are the k-splits of
// the four GEMM phases (W4A16: each covers whole groups of g_* rows), ws
// holds max(split * B * N) floats; W8A8: a8 holds B * max(D, HQ*HD, F)
// bytes, asc 4 * B floats. `grid` comes from pli_fused_decode_grid(mode).
// Returns the launch's error code.
extern "C" int pli_fused_decode_step(
    const void* x0, const void* ln1, const void* ln2, const void* wqkv,
    const void* sqkv, const void* wo, const void* swo, const void* wgu,
    const void* sgu, const void* wdn, const void* sdn, void* kq, void* ks,
    void* vq, void* vs, const void* cos, const void* sin, const void* q_slot,
    const void* valid_from, void* k_new, void* ks_new, void* v_new,
    void* vs_new, void* x_out, void* xf, void* h, void* qbuf, void* attn,
    void* ff, void* ws, void* a8, void* asc, int L, int B, int S, int D, int F,
    int HQ, int HKV, int HD, int slot, int write_cache, int split_qkv,
    int split_wo, int split_gu, int split_dn, int mode, int g_qkv, int g_wo,
    int g_gu, int g_dn, float eps, float scale, int grid, void* stream) {
  if (mode != W8A16 && mode != W4A16 && mode != W8A8)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  set_common(p, x0, ln1, ln2, wqkv, sqkv, wo, swo, wgu, sgu, wdn, sdn, cos, sin,
             k_new, ks_new, v_new, vs_new, x_out, xf, h, qbuf, attn, ff, ws);
  p.a8 = static_cast<int8_t*>(a8);
  p.asc = static_cast<float*>(asc);
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
  p.slot = slot; p.write_cache = write_cache;
  p.split_qkv = split_qkv; p.split_wo = split_wo;
  p.split_gu = split_gu; p.split_dn = split_dn;
  p.eps = eps; p.scale = scale;
  return launch(p, mode, grid, stream);
}

// K8. As K4, with the merged pools kv (L, NB, 2, BS, HKV*HD) int8 and kvs
// (L, NB, 2, HKV, BS) f32, lengths (B,) >= 0 and tables (B, MB) int32 whose
// entries are < NB; the pool rows are 16-byte aligned (HD % 16 == 0).
// inplace writes the new K/V into the pools. Returns the launch's error.
extern "C" int pli_fused_paged_decode_step(
    const void* x0, const void* ln1, const void* ln2, const void* wqkv,
    const void* sqkv, const void* wo, const void* swo, const void* wgu,
    const void* sgu, const void* wdn, const void* sdn, void* kv, void* kvs,
    const void* cos, const void* sin, const void* lengths, const void* tables,
    void* k_new, void* ks_new, void* v_new, void* vs_new, void* x_out,
    void* xf, void* h, void* qbuf, void* attn, void* ff, void* ws, int L,
    int B, int NB, int MB, int BS, int D, int F, int HQ, int HKV, int HD,
    int inplace, int split_qkv, int split_wo, int split_gu, int split_dn,
    float eps, float scale, int grid, void* stream) {
  Params p;
  set_common(p, x0, ln1, ln2, wqkv, sqkv, wo, swo, wgu, sgu, wdn, sdn, cos, sin,
             k_new, ks_new, v_new, vs_new, x_out, xf, h, qbuf, attn, ff, ws);
  p.a8 = nullptr;
  p.asc = nullptr;
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
  p.slot = -1; p.write_cache = inplace;
  p.split_qkv = split_qkv; p.split_wo = split_wo;
  p.split_gu = split_gu; p.split_dn = split_dn;
  p.eps = eps; p.scale = scale;
  return launch(p, 3, grid, stream);
}
