// One 64 x 128 output tile of y = x @ w for bf16 activations and INT4
// weights, accumulated in f32 on the tensor cores (WMMA bf16 m16n16k16).
//
// Used by fused_decode.cu (K4 in its W4A16 mode). The weights are the
// nibble-packed (K, N/2) bytes of models/quant.QuantizedTensor4: byte j of a
// row holds output column j in its low nibble and column N/2 + j in its high
// nibble. A tile reads packed bytes [j0, j0 + 64) of each K row once and
// makes both output column ranges, [j0, j0 + 64) and [N/2 + j0, N/2 + j0 +
// 64), so every weight byte crosses memory once per step: half the bytes of
// the W8A16 tile. The load stage and its register prefetch are the W8A16
// tile's (w8a16_tile.cuh), over rows of N/2 bytes; the store stage unpacks
// the nibbles (two arithmetic shifts, exact in bf16) into a low and a high
// bf16 weight tile. The caller scales the result by its group's scale row.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "w8a16_tile.cuh"

namespace w4a16 {

using w8a16::AS_LD;
using w8a16::BK;
using w8a16::BM;
using w8a16::BN;
using w8a16::BS_LD;
using w8a16::THREADS;
constexpr int CS_LD = 2 * BN + 4;  // f32 elements of a 64 x 128 result row

// The x tile and the two unpacked weight tiles during the K loop; the f32
// result tile after it, in the same bytes.
struct Smem {
  static constexpr int IN_BYTES = (BM * AS_LD + 2 * BK * BS_LD) * 2;
  static constexpr int C_BYTES = BM * CS_LD * 4;
  __align__(128) unsigned char raw[IN_BYTES > C_BYTES ? IN_BYTES : C_BYTES];
  __device__ __forceinline__ __nv_bfloat16* a() {
    return reinterpret_cast<__nv_bfloat16*>(raw);
  }
  // h = 0: the low nibbles (columns [j0, j0 + 64)); h = 1: the high ones
  __device__ __forceinline__ __nv_bfloat16* b(int h) {
    return a() + BM * AS_LD + h * BK * BS_LD;
  }
  __device__ __forceinline__ float* c() { return reinterpret_cast<float*>(raw); }
};

static __device__ __forceinline__ void store_stage(const w8a16::Stage& st, Smem& sm) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int id = tid + i * THREADS;
    const int row = id >> 3, col = (id & 7) * 8;
    *reinterpret_cast<uint4*>(&sm.a()[row * AS_LD + col]) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * THREADS;
    const int row = id >> 2, col = (id & 3) * 16;
    const int8_t* q = reinterpret_cast<const int8_t*>(&st.b[i]);
    __align__(16) __nv_bfloat16 lo[16];
    __align__(16) __nv_bfloat16 hi[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int v = q[e];
      lo[e] = __float2bfloat16(static_cast<float>(
          static_cast<int>(static_cast<unsigned>(v) << 28) >> 28));
      hi[e] = __float2bfloat16(static_cast<float>(v >> 4));
    }
    uint4* dlo = reinterpret_cast<uint4*>(&sm.b(0)[row * BS_LD + col]);
    uint4* dhi = reinterpret_cast<uint4*>(&sm.b(1)[row * BS_LD + col]);
    dlo[0] = reinterpret_cast<const uint4*>(lo)[0];
    dlo[1] = reinterpret_cast<const uint4*>(lo)[1];
    dhi[0] = reinterpret_cast<const uint4*>(hi)[0];
    dhi[1] = reinterpret_cast<const uint4*>(hi)[1];
  }
}

// Computes the f32 tile sum_{k in [k_begin, k_end)} x[m0+r, k] * w4[k, c]
// into sm.c() (64 rows x 128 columns, CS_LD): columns [0, 64) are output
// columns n0 + c of the low nibbles, [64, 128) columns NH + n0 + c - 64 of
// the high ones. x is (M, K) row-major bf16, wp the (K, NH) packed bytes.
// Ends with __syncthreads(), so sm.c() is ready to read; the caller must
// __syncthreads() after reading it, before the next call.
static __device__ __forceinline__ void tile_gemm(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wp, int M,
    int NH, int K, int k_begin, int k_end, int m0, int n0, bool vec_x,
    bool vec_w, Smem& sm) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[h][i][j], 0.f);

  w8a16::Stage st;
  if (k_begin < k_end) {
    w8a16::load_stage(st, x, wp, M, NH, K, k_begin, k_end, m0, n0, vec_x, vec_w);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    store_stage(st, sm);
    __syncthreads();
    if (k0 + BK < k_end) {
      w8a16::load_stage(st, x, wp, M, NH, K, k0 + BK, k_end, m0, n0, vec_x, vec_w);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sm.a()[(wm + i * 16) * AS_LD + kk], AS_LD);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[h][j], &sm.b(h)[kk * BS_LD + wn + j * 16], BS_LD);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[h][i][j], fa[i], fb[h][j], acc[h][i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&sm.c()[(wm + i * 16) * CS_LD + h * BN + wn + j * 16],
                                acc[h][i][j], CS_LD, wmma::mem_row_major);
  __syncthreads();
}

}  // namespace w4a16
