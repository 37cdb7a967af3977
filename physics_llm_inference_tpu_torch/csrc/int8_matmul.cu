// K1: W8A16 GEMM, y = (x @ w_q) * scale, for the prefill linears below
// 2,048 rows, the per-op decode linears and the lm_head.
//
// Replaces the TPU kernel physics_llm_inference_tpu/kernels/int8_matmul.py
// (int8_matmul -> _int8_matmul_kernel): int8 weights cast to the activation
// dtype, f32 accumulation over K, the per-column f32 scale applied once after
// the K sum, then a cast to the output dtype (bf16).
//
// What bounds it on the H100 depends on M: 2 M flop a weight byte against
// the card's ~295 flop/byte bf16 ridge. Two routes, picked by the wrapper
// (kernels/int8_matmul.pick_route), each its own kernel and launch counter:
//
// Route A, "stream" (decode-sized M: the per-op decode linears, the heads):
// bound by the weight bytes. It is the weight stream of the fused decode
// kernel (w8a16_stream.cuh) in an ordinary launch of one block an SM: a
// host plan (kernels/w8a16_stream.plan) splits the (64-row m-block, 256-
// byte slab, 64-row k-tile) units evenly over the blocks (stream-K); a
// producer thread TMAs each unit's int8 tile and a second one its x chunk
// through a 5-stage mbarrier ring; eight consumer warps make bf16 from the
// bytes with prmt and run mma.sync, the live m16 tiles a template
// parameter; each block's run of k-tiles within a slab is one f32 partial.
//
// Route B, "wgmma" (prefill-sized M): bound by operations from M ~ 148. It
// computes y^T = w^T x^T so that the weights are wgmma's A, widened to bf16
// in registers, and x is B, read from shared memory as TMA put it. A block
// is 128 output columns (64 a consumer warpgroup) x NR = 128 or 256 rows
// of x (wgmma m64nNRk16), three warpgroups: one thread of the third TMAs
// each k-tile's x (NR x 64, K-major, 128-byte swizzled) and int8 weight
// box (64 x 128) into a 5-8 stage ring; each consumer lane reads, a 16-bit
// load a k-row, the bytes of its A fragment (A row 16 w + g is output
// column 2 g of its warp's 16, row 16 w + g + 8 column 2 g + 1, so one
// load gives both) and widens them with the exact 2^23 + 128 + q prmt of
// w8a16_stream.cuh, into one of two register sets: the other is read by
// the wgmma in flight. Each weight byte is read once a block and widened
// once for NR rows; nothing is written back to shared memory. (A first
// form widened each tile into a bf16 copy in shared memory, K9's B layout,
// and ran K9's m64n256k16 on it: 18-25% slower from M = 256 on, its
// copy's traffic bounding it.) K is split over blockIdx.z when the tiles
// alone would leave SMs idle (the wrapper's cost rule).
//
// Both routes end with fixed-order sums: a second launch (finalize) adds a
// column's f32 partials in index order, scales and casts, so two launches
// on the same inputs give the same bits. Route B with one split writes the
// bf16 output from its accumulators. TMA zero-fills past M, N and K; rows
// need 16-byte pitches (K % 8, N % 16), which the wrapper pads otherwise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w8a16_stream.cuh"
#include "wgmma.cuh"

namespace {

using w8s::W8A16;

// ---- route A: the weight stream ---------------------------------------------

constexpr size_t STREAM_SMEM = 1024 + w8s::Geo<W8A16>::RING_BYTES;

__global__ void __launch_bounds__(w8s::THREADS, 1)
int8_matmul_stream_kernel(const w8s::Plan pl, const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ CUtensorMap xmap, float* __restrict__ ws,
                          int M, int N) {
  extern __shared__ unsigned char dsmem[];
  const w8s::Ring<W8A16> ring{(w8s::smem_u32(dsmem) + 1023) & ~1023u};
  if (w8s::thread0()) w8s::ring_init(ring);
  __syncthreads();
  if (threadIdx.x >= w8s::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(w8s::PRODUCER_REGS));
    uint32_t it = 0;
    if (threadIdx.x == w8s::CONSUMERS) {
      w8s::produce(pl, &wmap, nullptr, 0, N, 1, ring, it);
    } else if (threadIdx.x == w8s::CONSUMERS + 32) {
      w8s::produce_x(pl, &xmap, 0, ring, it);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(w8s::CONSUMER_REGS));
  w8s::open_phase(ring, 0);   // x was written before the launch
  uint32_t it = 0;
  w8s::consume_w8(pl, ws, M, N, ring, it);
}

// ---- route B: y^T = w^T x^T on wgmma, the weights widened into A's registers ---

constexpr int BK = 64, W_COLS = 128;
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;
constexpr int W_BOX = BK * w8s::BOX;      // 8 KB: an int8 box, 64 k-rows of 128 columns
// wgmma descriptor strides (bytes) of the x tile, K-major: 8-row groups
// 1024 B apart (the leading offset is unused)
constexpr uint32_t X_LBO = 16, X_SBO = 1024;

// A block: W_COLS = 128 output columns (each consumer warpgroup 64: wgmma's
// M) x NR rows of x (wgmma's N, 256 or 128); a stage holds the x tile (NR
// rows x 64, K-major: wgmma's B) and the weights' 64 x 128 int8 box.
template <int NR>
struct Tile {
  static constexpr int X_BYTES = NR * BK * 2;
  static constexpr int STAGE_BYTES = X_BYTES + W_BOX;
  static constexpr int STAGES = (200 * 1024) / STAGE_BYTES;
  static constexpr size_t SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
  static_assert(SMEM <= 232448, "over the H100's 227 KB a block");
};

static __device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// The lane's A fragments of one stage's weight box (64 k-rows x 128 bytes,
// 128-byte swizzled): A row 16 w + g of its warpgroup is output column
// `col` (= 64 wg + 16 w + 2 g), row 16 w + g + 8 column col + 1, so one
// 16-bit load a k-row gives both; k16 step kk reads k-rows kk * 16 + 2 t +
// {0, 1, 8, 9}. Eight lanes of a load read 16 bytes of one row, four rows
// apart in the swizzle: no bank is shared.
static __device__ __forceinline__ void weight_frags(uint32_t (&a)[4][4], uint32_t box, int col,
                                                    int t) {
  const uint32_t chunk = col >> 4, byte = col & 15;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = kk * 16 + 2 * t + (j & 1) + (j >> 1) * 8;
      h[j] = lds16(box + row * w8s::BOX + ((chunk ^ (row & 7)) << 4) + byte);
    }
    // bytes: k-row r column col, r col + 1, r + 1 col, r + 1 col + 1
    const uint32_t lo = __byte_perm(h[0], h[1], 0x5410) ^ 0x80808080u;
    const uint32_t hi = __byte_perm(h[2], h[3], 0x5410) ^ 0x80808080u;
    a[kk][0] = w8s::pack_bf16(kv_attn::byte_f32(lo, 0), kv_attn::byte_f32(lo, 2));
    a[kk][1] = w8s::pack_bf16(kv_attn::byte_f32(lo, 1), kv_attn::byte_f32(lo, 3));
    a[kk][2] = w8s::pack_bf16(kv_attn::byte_f32(hi, 0), kv_attn::byte_f32(hi, 2));
    a[kk][3] = w8s::pack_bf16(kv_attn::byte_f32(hi, 1), kv_attn::byte_f32(hi, 3));
  }
}

template <int NR>
static __device__ __forceinline__ void wgmma_rs(float (&d)[NR / 2], const uint32_t (&a)[4],
                                                uint64_t db) {
  if constexpr (NR == 256) {
    wgmma_rs_m64n256k16(d, a, db);
  } else {
    wgmma_rs_m64n128k16(d, a, db);
  }
}

template <int NR>
__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, const float* __restrict__ scale,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int M, int N,
                      int ktn, int splits) {
  using G = Tile<NR>;
  extern __shared__ unsigned char dsmem[];
  const uint32_t base = (w8s::smem_u32(dsmem) + 1023) & ~1023u;
  const uint32_t bars = base + G::STAGES * G::STAGE_BYTES;
  auto stage = [&](int s) { return base + s * G::STAGE_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (G::STAGES + s); };
  const int n0 = blockIdx.x * W_COLS, m0 = blockIdx.y * NR, z = blockIdx.z;
  const int k0 = z * ktn / splits, nk = (z + 1) * ktn / splits - k0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      w8s::mbar_init(full(s), 1);
      w8s::mbar_init(empty(s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % G::STAGES, kt = (k0 + i) * BK;
        w8s::mbar_wait(empty(s), ((i / G::STAGES) & 1) ^ 1);
        w8s::mbar_expect_tx(full(s), G::STAGE_BYTES);
        w8s::tma_load_2d(stage(s), &xmap, full(s), kt, m0);
        w8s::tma_load_3d(stage(s) + G::X_BYTES, &wmap, full(s), n0, kt, 0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int col = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + 2 * g;   // in the block's 128
  float d[NR / 2];
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) d[i] = 0.f;
  // two register sets of A fragments: one is read by the wgmma in flight
  uint32_t a0[4][4], a1[4][4];
  auto step = [&](int i, uint32_t (&a)[4][4]) {
    const int s = i % G::STAGES;
    w8s::mbar_wait(full(s), (i / G::STAGES) & 1);
    weight_frags(a, stage(s) + G::X_BYTES, col, t);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<NR>(d, a[kk], gmma_desc(stage(s) + kk * 32, X_LBO, X_SBO));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the previous stage's wgmma is done: its stage and register set are free
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (i > 0 && lane == 0) w8s::mbar_arrive(empty((i - 1) % G::STAGES));
  };
  for (int i = 0; i < nk; i += 2) {
    step(i, a0);
    if (i + 1 < nk) step(i + 1, a1);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");

  // fragment 4 i + e holds output column col, row 8 i + 2 t + e of the
  // block's x rows; 4 i + 2 + e column col + 1 (N % 16 == 0: both or none)
  const int gc = n0 + col;
  if (gc >= N) return;
  const float2 sc = ws == nullptr ? __ldg(reinterpret_cast<const float2*>(scale + gc))
                                  : make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < NR / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * i + 2 * t + e;
      if (row >= M) continue;
      const float v0 = d[4 * i + e], v1 = d[4 * i + 2 + e];
      if (ws == nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + gc) =
            __floats2bfloat162_rn(v0 * sc.x, v1 * sc.y);
      } else {
        *reinterpret_cast<float2*>(ws + ((size_t)z * M + row) * N + gc) = make_float2(v0, v1);
      }
    }
  }
}

// ---- the fixed-order sum of the partials --------------------------------------

// out[m, n..n+3] = bf16(sum over j of ws[j, m, n..n+3], in index order, *
// scale): route A's partials of that column (its plan), or route B's
// `splits`.
__global__ void int8_matmul_finalize(const float* __restrict__ ws,
                                     const float* __restrict__ scale,
                                     __nv_bfloat16* __restrict__ out, const w8s::Plan pl,
                                     int splits, int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = N / 4;
  if (i >= (size_t)M * q) return;
  const int m = static_cast<int>(i / q), n = static_cast<int>(i % q) * 4;
  const int cnt = splits > 0 ? splits : w8s::partials<W8A16>(pl, m, n, N);
  const size_t mn = (size_t)M * N;
  const float* p = ws + (size_t)m * N + n;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < cnt; ++j) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + j * mn));
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + n));
  const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * sc.x, acc.y * sc.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * sc.z, acc.w * sc.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out + (size_t)m * N + n) = u;
}

}  // namespace

// Route A's partials: ws (most, M, N) f32 of x (M, K) bf16 @ w (K, N) int8
// on the plan {most, tiles, blocks, ktn, slabs} (kernels/w8a16_stream.plan);
// one launch of `blocks` blocks. Shared with K3 (lmhead.cu). Returns the
// launch's error.
int k1_stream_partials(const void* x, const void* w, float* ws, int M, int N, int K,
                       const w8s::Plan& pl, cudaStream_t st) {
  CUtensorMap wmap, xmap;
  if (!w8s::encode_weights(&wmap, w, 1, K, N) || !w8s::encode_x(&xmap, x, M, K, 2 * K, false))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(STREAM_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_matmul_stream_kernel<<<pl.blocks, w8s::THREADS, STREAM_SMEM, st>>>(pl, wmap, xmap, ws, M,
                                                                          N);
  return static_cast<int>(cudaGetLastError());
}

// x (M, K) bf16, w (K, N) int8 and scale (N,) f32 are contiguous and
// 16-byte aligned, K % 8 == 0, N % 16 == 0; out (M, N) bf16. Route A (the
// stream): the plan {most, tiles, blocks, ktn, slabs}, ws (most, M, N) f32.
// Returns cudaGetLastError() after the launches.
extern "C" int pli_int8_matmul_stream(const void* x, const void* w, const void* scale,
                                      void* out, void* ws, int M, int N, int K, int most,
                                      int tiles, int blocks, int ktn, int slabs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const w8s::Plan pl{tiles, blocks, ktn, slabs, most};
  float* part = static_cast<float*>(ws);
  const int err = k1_stream_partials(x, w, part, M, N, K, pl, st);
  if (err != 0) return err;
  const size_t quads = (size_t)M * N / 4;
  int8_matmul_finalize<<<static_cast<unsigned>((quads + 255) / 256), 256, 0, st>>>(
      part, static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), pl, 0, M, N);
  return static_cast<int>(cudaGetLastError());
}

template <int NR>
static int launch_wgmma(const void* x, const void* w, const void* scale, void* out, void* ws, int M,
                     int N, int K, int splits, cudaStream_t st) {
  CUtensorMap xmap, wmap;
  if (!w8s::encode_x(&xmap, x, M, K, 2 * K, false, NR) || !w8s::encode_weights(&wmap, w, 1, K, N))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(int8_matmul_wgmma_kernel<NR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Tile<NR>::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const dim3 grid((N + W_COLS - 1) / W_COLS, (M + NR - 1) / NR, splits);
  int8_matmul_wgmma_kernel<NR><<<grid, THREADS, Tile<NR>::SMEM, st>>>(
      xmap, wmap, static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), part, M, N,
      (K + BK - 1) / BK, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t quads = (size_t)M * N / 4;
  int8_matmul_finalize<<<static_cast<unsigned>((quads + 255) / 256), 256, 0, st>>>(
      part, static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), w8s::Plan{},
      splits, M, N);
  return static_cast<int>(cudaGetLastError());
}

// Route B (wgmma): the same operands, `rows` (128 or 256) rows of x a
// block; K split `splits` ways (k-tiles of 64 rows [z * ktn / splits, (z +
// 1) * ktn / splits)), ws (splits, M, N) f32 when splits > 1, else unused.
extern "C" int pli_int8_matmul_wgmma(const void* x, const void* w, const void* scale,
                                     void* out, void* ws, int M, int N, int K, int rows,
                                     int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rows == 128 ? launch_wgmma<128>(x, w, scale, out, ws, M, N, K, splits, st)
                     : launch_wgmma<256>(x, w, scale, out, ws, M, N, K, splits, st);
}
