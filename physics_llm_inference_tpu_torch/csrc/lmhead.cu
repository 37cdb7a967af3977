// K3: fused greedy head, tokens = argmax(bf16(rms_norm(x) @ lm_q * lm_s)).
//
// Replaces the TPU kernel physics_llm_inference_tpu/kernels/lmhead.py
// (lmhead_greedy -> _lmhead_kernel): RMSNorm in f32, cast to the model dtype,
// INT8 head matmul with an f32 accumulator, per-column scale, a round to bf16
// (the per-op path's int8_matmul writes bf16 logits), then argmax with the
// first-max index. The (B, V) logits never reach device memory.
//
// Bound on the H100: the (D, V) int8 head bytes (131 MB at D = 4096,
// V = 32000 against 0.5 MB of activations). Three launches on one stream:
//  1. one block per row normalizes x into a bf16 scratch row and clears that
//     row's packed (max, index) slot;
//  2. blocks over 64-column V-tiles run the shared W8A16 tile
//     (w8a16_tile.cuh: weights streamed along V, 16 bytes a thread) and
//     reduce each row of the tile to (max, first index); blocks finish in no
//     order, so each row's winner is folded in with one 64-bit atomicMax on
//     (order-preserving float bits << 32 | ~index): a larger value wins, and
//     among equal values the smaller index, which is the first-max rule;
//  3. one thread per row unpacks the index.

#include <cuda_runtime.h>
#include <math.h>

#include "w8a16_tile.cuh"

namespace {

__global__ void rmsnorm_rows(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             __nv_bfloat16* __restrict__ xn,
                             unsigned long long* __restrict__ packed, int D,
                             float eps) {
  __shared__ float red[32];
  const int b = blockIdx.x;
  const __nv_bfloat16* xr = x + (size_t)b * D;
  float ss = 0.f;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float v = __bfloat162float(xr[c]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (threadIdx.x == 0) red[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(red[0] / D + eps);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const float v = __bfloat162float(xr[c]) * inv * __bfloat162float(w[c]);
    xn[(size_t)b * D + c] = __float2bfloat16(v);
  }
  if (threadIdx.x == 0) packed[b] = 0ull;
}

__device__ __forceinline__ unsigned int orderable(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(w8a16::THREADS)
lmhead_argmax_kernel(const __nv_bfloat16* __restrict__ xn,
                     const int8_t* __restrict__ lm_q,
                     const float* __restrict__ lm_s,
                     unsigned long long* __restrict__ packed, int B, int D,
                     int V, int vec_x, int vec_w) {
  using namespace w8a16;
  __shared__ __align__(128) unsigned char smem_raw[sizeof(Smem)];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  tile_gemm(xn, lm_q, B, V, D, 0, D, m0, n0, vec_x != 0, vec_w != 0, sm);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int gm = m0 + r;
    if (gm >= B) break;
    float best = -INFINITY;
    int idx = 0x7fffffff;
    for (int c = lane; c < BN; c += 32) {
      const int gn = n0 + c;
      if (gn < V) {
        const float v = __bfloat162float(
            __float2bfloat16(sm.c[r * CS_LD + c] * lm_s[gn]));
        if (v > best || (v == best && gn < idx)) {
          best = v;
          idx = gn;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
      if (ob > best || (ob == best && oi < idx)) {
        best = ob;
        idx = oi;
      }
    }
    if (lane == 0 && idx != 0x7fffffff) {
      const unsigned long long key =
          ((unsigned long long)orderable(best) << 32) |
          (unsigned long long)(0xffffffffu - (unsigned int)idx);
      atomicMax(&packed[gm], key);
    }
  }
}

__global__ void unpack_tokens(const unsigned long long* __restrict__ packed,
                              int* __restrict__ tok, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) tok[b] = (int)(0xffffffffu - (unsigned int)(packed[b] & 0xffffffffull));
}

}  // namespace

// x (B, D) bf16, norm_w (D,) bf16, lm_q (D, V) int8, lm_s (V,) f32, all
// contiguous; xn (B, D) bf16 and packed (B,) 64-bit are scratch; tok (B,)
// int32 receives the tokens. Returns cudaGetLastError().
extern "C" int pli_lmhead_greedy(const void* x, const void* norm_w,
                                 const void* lm_q, const void* lm_s, void* xn,
                                 void* packed, void* tok, int B, int D, int V,
                                 float eps, int vec_w, void* stream) {
  using namespace w8a16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* pk = static_cast<unsigned long long*>(packed);
  rmsnorm_rows<<<B, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                  static_cast<const __nv_bfloat16*>(norm_w),
                                  static_cast<__nv_bfloat16*>(xn), pk, D, eps);
  dim3 grid((V + BN - 1) / BN, (B + BM - 1) / BM);
  lmhead_argmax_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(xn), static_cast<const int8_t*>(lm_q),
      static_cast<const float*>(lm_s), pk, B, D, V, (D % 8) == 0, vec_w);
  unpack_tokens<<<(B + 127) / 128, 128, 0, st>>>(pk, static_cast<int*>(tok), B);
  return static_cast<int>(cudaGetLastError());
}
