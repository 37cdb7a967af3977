// One 64x64 output tile of y = x @ w for bf16 activations and int8 weights,
// accumulated in f32 on the tensor cores (WMMA bf16 m16n16k16).
//
// Shared by int8_matmul.cu (K1), lmhead.cu (K3) and fused_decode.cu (K4).
// All are bound by the int8 weight stream at decode sizes (M = 64: 2*64
// flop per weight byte,
// against the H100's ~295 flop/byte ridge), so the tile is built around
// moving weight bytes:
//  - w is read along N, its contiguous axis, 16 bytes per thread per load;
//  - int8 -> bf16 happens in registers (exact for |q| <= 127), so the tensor
//    cores see bare casts and the per-column scale is applied once, after the
//    K sum, by the caller;
//  - the next K-slice is loaded into registers while the current one is in
//    the tensor cores (one-stage register prefetch);
//  - ragged M, N and K are masked with zeros, so no shape needs to divide;
//  - x is read through L2 (ld.global.cg): in the fused decode kernel
//    (fused_decode.cu), which also uses this tile, another block of the same
//    launch wrote it, and L1 is not coherent across SMs.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace w8a16 {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;       // 4 warps, 2x2 over the 64x64 tile
constexpr int AS_LD = BK + 8;      // bf16 elements; padding breaks bank conflicts
constexpr int BS_LD = BN + 8;
constexpr int CS_LD = BN + 4;      // f32 elements

struct Smem {
  __nv_bfloat16 a[BM * AS_LD];     // x tile  (BM x BK)
  __nv_bfloat16 b[BK * BS_LD];     // w tile  (BK x BN), dequantized to bf16
  float c[BM * CS_LD];             // f32 result tile (BM x BN)
};

// Registers holding one K-slice in flight: 4 x 8 bf16 of x, 2 x 16 int8 of w.
struct Stage {
  uint4 a[4];
  uint4 b[2];
};

static __device__ __forceinline__ void load_stage(
    Stage& st, const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    int M, int N, int K, int k0, int k_end, int m0, int n0, bool vec_x,
    bool vec_w) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int id = tid + i * THREADS;          // 0..511: 64 rows x 8 chunks
    const int row = id >> 3, col = (id & 7) * 8;
    const int gm = m0 + row, gk = k0 + col;
    if (vec_x && gm < M && gk + 8 <= k_end) {
      st.a[i] = __ldcg(reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk));
    } else {
      __align__(16) unsigned short tmp[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        tmp[e] = (gm < M && gk + e < k_end)
                     ? __ldcg(reinterpret_cast<const unsigned short*>(
                           x + (size_t)gm * K + gk + e))
                     : static_cast<unsigned short>(0);   // bf16 +0
      }
      st.a[i] = *reinterpret_cast<const uint4*>(tmp);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * THREADS;          // 0..255: 64 rows x 4 chunks
    const int row = id >> 2, col = (id & 3) * 16;
    const int gk = k0 + row, gn = n0 + col;
    if (vec_w && gk < k_end && gn + 16 <= N) {
      st.b[i] = *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn);
    } else {
      __align__(16) int8_t tmp[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        tmp[e] = (gk < k_end && gn + e < N) ? w[(size_t)gk * N + gn + e] : 0;
      }
      st.b[i] = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

static __device__ __forceinline__ void store_stage(const Stage& st, Smem& sm) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int id = tid + i * THREADS;
    const int row = id >> 3, col = (id & 7) * 8;
    *reinterpret_cast<uint4*>(&sm.a[row * AS_LD + col]) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * THREADS;
    const int row = id >> 2, col = (id & 3) * 16;
    const int8_t* q = reinterpret_cast<const int8_t*>(&st.b[i]);
    __align__(16) __nv_bfloat16 deq[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) deq[e] = __float2bfloat16(static_cast<float>(q[e]));
    uint4* dst = reinterpret_cast<uint4*>(&sm.b[row * BS_LD + col]);
    dst[0] = reinterpret_cast<const uint4*>(deq)[0];
    dst[1] = reinterpret_cast<const uint4*>(deq)[1];
  }
}

// Computes the f32 tile sum_{k in [k_begin, k_end)} x[m0+r, k] * w[k, n0+c]
// into sm.c (row-major, CS_LD). x is (M, K) row-major bf16, w is (K, N)
// row-major int8. Ends with __syncthreads(), so sm.c is ready to read.
static __device__ __forceinline__ void tile_gemm(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w, int M,
    int N, int K, int k_begin, int k_end, int m0, int n0, bool vec_x,
    bool vec_w, Smem& sm) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Stage st;
  if (k_begin < k_end) {
    load_stage(st, x, w, M, N, K, k_begin, k_end, m0, n0, vec_x, vec_w);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    store_stage(st, sm);
    __syncthreads();
    if (k0 + BK < k_end) {
      load_stage(st, x, w, M, N, K, k0 + BK, k_end, m0, n0, vec_x, vec_w);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sm.a[(wm + i * 16) * AS_LD + kk], AS_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sm.b[kk * BS_LD + wn + j * 16], BS_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&sm.c[(wm + i * 16) * CS_LD + wn + j * 16], acc[i][j],
                              CS_LD, wmma::mem_row_major);
  __syncthreads();
}

}  // namespace w8a16
