// One 64x64 output tile of y = x @ w for int8 activations and int8 weights,
// accumulated exactly in int32 on the tensor cores (WMMA s8 m16n16k16).
//
// Used by fused_decode.cu (K4 in its W8A8 mode), whose activation rows are
// quantized to int8 inside the launch; x is therefore read through L2
// (ld.global.cg). Both operands are int8, so the tile moves the same weight
// bytes as the W8A16 tile and feeds the int8 tensor cores bare. A product
// of int8 values summed in int32 is exact, so K-split partials add up to
// the same integer in any order; the caller applies the row and column
// scales to that sum.
//
// Shared-memory layout: WMMA wants 256-bit aligned fragment pointers, and a
// 16-wide int8 fragment is 16 bytes, so each operand is stored as four
// slabs of 16 bytes a row (x: one slab per 16 columns of K; w: one per 16
// columns of N), each slab padded by 32 bytes so that the four slabs of a
// row land on different banks. Fragments are then loaded with ldm = 16.
#pragma once

#include <mma.h>
#include <stdint.h>

namespace w8a8 {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;     // 4 warps, 2x2 over the 64x64 tile
constexpr int SLAB = 64 * 16 + 32;  // bytes of one 16-byte-wide slab
constexpr int CS_LD = BN + 4;       // int32 elements

struct Smem {
  __align__(128) signed char a[4 * SLAB];  // x tile: slab k/16, row m, k%16
  __align__(128) signed char b[4 * SLAB];  // w tile: slab n/16, row k, n%16
  int c[BM * CS_LD];                       // int32 result tile (BM x BN)
};

// Registers holding one K-slice in flight: 2 x 16 int8 of x, 2 x 16 of w.
struct Stage {
  uint4 a[2];
  uint4 b[2];
};

static __device__ __forceinline__ void load_stage(
    Stage& st, const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    int M, int N, int K, int k0, int k_end, int m0, int n0, bool vec_x,
    bool vec_w) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * THREADS;          // 0..255: 64 rows x 4 chunks
    const int row = id >> 2, col = (id & 3) * 16;
    const int gm = m0 + row, gk = k0 + col;
    if (vec_x && gm < M && gk + 16 <= k_end) {
      st.a[i] = __ldcg(reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk));
    } else {
      __align__(16) signed char tmp[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        tmp[e] = (gm < M && gk + e < k_end)
                     ? __ldcg(reinterpret_cast<const signed char*>(x + (size_t)gm * K + gk + e))
                     : static_cast<signed char>(0);
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
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * THREADS;
    const int row = id >> 2, slab = id & 3;
    *reinterpret_cast<uint4*>(&sm.a[slab * SLAB + row * 16]) = st.a[i];
    *reinterpret_cast<uint4*>(&sm.b[slab * SLAB + row * 16]) = st.b[i];
  }
}

// Computes the int32 tile sum_{k in [k_begin, k_end)} x[m0+r, k] * w[k, n0+c]
// into sm.c (row-major, CS_LD). x is (M, K) row-major int8, w is (K, N)
// row-major int8. Ends with __syncthreads(), so sm.c is ready to read.
static __device__ __forceinline__ void tile_gemm(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, int M, int N,
    int K, int k_begin, int k_end, int m0, int n0, bool vec_x, bool vec_w,
    Smem& sm) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sm.a[(kk / 16) * SLAB + (wm + i * 16) * 16], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &sm.b[((wn + j * 16) / 16) * SLAB + kk * 16], 16);
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

}  // namespace w8a8
