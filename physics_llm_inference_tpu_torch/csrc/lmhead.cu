// K3: fused greedy head, tokens = argmax(bf16(rms_norm(x) @ lm_q * lm_s)).
//
// Replaces the TPU kernel physics_llm_inference_tpu/kernels/lmhead.py
// (lmhead_greedy -> _lmhead_kernel): RMSNorm in f32, cast to the model dtype,
// INT8 head matmul with an f32 accumulator, per-column scale, a round to bf16
// (the per-op path's int8_matmul writes bf16 logits), then argmax with the
// first-max index. The (B, V) logits never reach device memory.
//
// Bound on the H100: the (D, V) int8 head bytes (131 MB at D = 4096,
// V = 32000 against 0.5 MB of activations). Four launches on one stream:
//  1. one block per row normalizes x into a bf16 scratch row (zero past D
//     up to its 16-byte pitch) and clears that row's packed (max, index)
//     slot;
//  2. K1's weight stream (int8_matmul.cu, route A) over the head: f32
//     partials of the logits, a column's split over the blocks of its plan;
//  3. per row and column range, each column's partials summed in index
//     order, scaled, rounded to bf16 (never a partial), and the range's
//     (max, first index) folded into the row's slot with one 64-bit
//     atomicMax on (order-preserving float bits << 32 | ~index): a larger
//     value wins, and among equal values the smaller index, which is the
//     first-max rule; columns past V (the wrapper's padding) take no part;
//  4. one thread per row unpacks the index.

#include <cuda_runtime.h>
#include <math.h>

#include "w8a16_stream.cuh"

// K1's route A: the f32 partials of x (M, K) @ w (K, N) on plan `pl`
// (int8_matmul.cu).
int k1_stream_partials(const void* x, const void* w, float* ws, int M, int N, int K,
                       const w8s::Plan& pl, cudaStream_t st);

namespace {

__global__ void rmsnorm_rows(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             __nv_bfloat16* __restrict__ xn,
                             unsigned long long* __restrict__ packed, int D,
                             int pitch, float eps) {
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
  for (int c = threadIdx.x; c < pitch; c += blockDim.x) {
    const float v = c < D ? __bfloat162float(xr[c]) * inv * __bfloat162float(w[c]) : 0.f;
    xn[(size_t)b * pitch + c] = __float2bfloat16(v);
  }
  if (threadIdx.x == 0) packed[b] = 0ull;
}

__device__ __forceinline__ unsigned int orderable(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

constexpr int FOLD_THREADS = 256, FOLD_COLS = 4 * FOLD_THREADS;

// Row blockIdx.y, columns [blockIdx.x * FOLD_COLS, + FOLD_COLS), four a
// thread: the bf16 logits from the partials ws (most, B, N) of plan `pl`,
// and their (max, first index) into packed[row].
__global__ void __launch_bounds__(FOLD_THREADS)
lmhead_fold(const float* __restrict__ ws, const float* __restrict__ lm_s, const w8s::Plan pl,
            unsigned long long* __restrict__ packed, int B, int N, int V) {
  __shared__ float sbest[FOLD_THREADS / 32];
  __shared__ int sidx[FOLD_THREADS / 32];
  const int b = blockIdx.y, n = blockIdx.x * FOLD_COLS + 4 * threadIdx.x;
  float best = -INFINITY;
  int idx = 0x7fffffff;
  if (n < V) {
    const int cnt = w8s::partials<w8s::W8A16>(pl, b, n, N);
    const size_t bn = (size_t)B * N;
    const float* p = ws + (size_t)b * N + n;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < cnt; ++j) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + j * bn));
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    // N % 16 == 0: the scales of all four columns exist (past V: padding)
    const float4 sc = __ldg(reinterpret_cast<const float4*>(lm_s + n));
    // ascending columns, a strict >: the first of equal values stays
    auto take = [&](float a, float s, int c) {
      const float v = __bfloat162float(__float2bfloat16(a * s));
      if (c < V && v > best) {
        best = v;
        idx = c;
      }
    };
    take(acc.x, sc.x, n);
    take(acc.y, sc.y, n + 1);
    take(acc.z, sc.z, n + 2);
    take(acc.w, sc.w, n + 3);
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sbest[warp] = best;
    sidx[warp] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < FOLD_THREADS / 32; ++i) {
      if (sbest[i] > best || (sbest[i] == best && sidx[i] < idx)) {
        best = sbest[i];
        idx = sidx[i];
      }
    }
    if (idx != 0x7fffffff) {
      const unsigned long long key =
          ((unsigned long long)orderable(best) << 32) |
          (unsigned long long)(0xffffffffu - (unsigned int)idx);
      atomicMax(&packed[b], key);
    }
  }
}

__global__ void unpack_tokens(const unsigned long long* __restrict__ packed,
                              int* __restrict__ tok, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) tok[b] = (int)(0xffffffffu - (unsigned int)(packed[b] & 0xffffffffull));
}

}  // namespace

// x (B, D) bf16, norm_w (D,) bf16, lm_q (DP, NP) int8 (rows past D zero;
// DP % 8 == 0, NP % 16 == 0, 16-byte aligned), lm_s (NP,) f32, all
// contiguous; xn (B, DP) bf16, ws (most, B, NP) f32 and packed (B,) 64-bit
// are scratch; tok (B,) int32 receives the tokens over the first V columns.
// The plan {most, tiles, blocks, ktn, slabs} is K1's route A plan of (B, NP,
// DP). Returns the launches' error.
extern "C" int pli_lmhead_greedy(const void* x, const void* norm_w, const void* lm_q,
                                 const void* lm_s, void* xn, void* ws, void* packed, void* tok,
                                 int B, int D, int DP, int V, int NP, float eps, int most,
                                 int tiles, int blocks, int ktn, int slabs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* pk = static_cast<unsigned long long*>(packed);
  rmsnorm_rows<<<B, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                  static_cast<const __nv_bfloat16*>(norm_w),
                                  static_cast<__nv_bfloat16*>(xn), pk, D, DP, eps);
  const w8s::Plan pl{tiles, blocks, ktn, slabs, most};
  float* part = static_cast<float*>(ws);
  const int err = k1_stream_partials(xn, lm_q, part, B, NP, DP, pl, st);
  if (err != 0) return err;
  lmhead_fold<<<dim3((V + FOLD_COLS - 1) / FOLD_COLS, B), FOLD_THREADS, 0, st>>>(
      part, static_cast<const float*>(lm_s), pl, pk, B, NP, V);
  unpack_tokens<<<(B + 127) / 128, 128, 0, st>>>(pk, static_cast<int*>(tok), B);
  return static_cast<int>(cudaGetLastError());
}
