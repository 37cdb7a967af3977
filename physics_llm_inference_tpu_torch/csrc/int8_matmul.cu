// K1: W8A16 GEMM, y = (x @ w_q) * scale, for the per-op decode linears and
// the prefill lm_head.
//
// Replaces the TPU kernel physics_llm_inference_tpu/kernels/int8_matmul.py
// (int8_matmul -> _int8_matmul_kernel): int8 weights cast to the activation
// dtype, f32 accumulation over K, the per-column f32 scale applied once after
// the K sum, then a cast to the output dtype (bf16).
//
// Bound on the H100: weight bytes. At decode M = 64 every weight byte feeds
// 128 flop, far below the card's ~295 flop/byte ridge, so the kernel's job
// is to stream the int8 weights at full bandwidth (see w8a16_tile.cuh for
// the tile). Blocks run in no order on 132 SMs: a 64-column tile grid alone
// gives N = 4096 only 64 blocks, so K is split across blocks (split-K) until
// about two waves are in flight. Each split writes an f32 partial tile to a
// workspace and a second, tiny pass sums the splits in a fixed order (the
// result does not depend on block scheduling), applies the scale and casts.
// With one split the first pass applies the scale itself.

#include <cuda_runtime.h>

#include "w8a16_tile.cuh"

namespace {

__global__ void __launch_bounds__(w8a16::THREADS)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                   int M, int N, int K, int kt_per_split, int vec_x, int vec_w) {
  using namespace w8a16;
  __shared__ __align__(128) unsigned char smem_raw[sizeof(Smem)];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int k_begin = split * kt_per_split * BK;
  const int k_end = min(K, k_begin + kt_per_split * BK);
  tile_gemm(x, w, M, N, K, k_begin, k_end, m0, n0, vec_x != 0, vec_w != 0, sm);

  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const float acc = sm.c[r * CS_LD + c];
    if (ws != nullptr) {
      ws[((size_t)split * M + gm) * N + gn] = acc;
    } else {
      out[(size_t)gm * N + gn] = __float2bfloat16(acc * scale[gn]);
    }
  }
}

__global__ void splitk_finalize(const float* __restrict__ ws,
                                const float* __restrict__ scale,
                                __nv_bfloat16* __restrict__ out, int M, int N,
                                int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += ws[(size_t)s * mn + i];
  out[i] = __float2bfloat16(acc * scale[i % N]);
}

}  // namespace

// x (M, K) bf16, w (K, N) int8 and scale (N,) f32 are contiguous; out (M, N)
// bf16. ws is (splits, M, N) f32 when splits > 1, else unused. Returns
// cudaGetLastError() after the launches.
extern "C" int pli_int8_matmul(const void* x, const void* w, const void* scale,
                               void* out, void* ws, int M, int N, int K,
                               int splits, int kt_per_split, int vec_x,
                               int vec_w, void* stream) {
  using namespace w8a16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int8_matmul_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      splits > 1 ? static_cast<float*>(ws) : nullptr, M, N, K, kt_per_split,
      vec_x, vec_w);
  if (splits > 1) {
    const size_t mn = (size_t)M * N;
    const int threads = 256;
    const unsigned blocks = (unsigned)((mn + threads - 1) / threads);
    splitk_finalize<<<blocks, threads, 0, st>>>(
        static_cast<const float*>(ws), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), M, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
