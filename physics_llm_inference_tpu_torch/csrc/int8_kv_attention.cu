// K2: one-query GQA decode attention over the INT8 KV cache.
//
// Replaces the TPU kernel physics_llm_inference_tpu/kernels/
// int8_kv_attention.py (int8_kv_decode_attention -> _kernel). Same contract:
// K and V are bare int8 values in the flat (B, S, Hkv*d) layout, their f32
// scales are transposed (B, Hkv, S); the k-scale multiplies the score row and
// the v-scale the probability row, so neither K nor V is dequantized element
// by element; the mask is valid_from[b] <= k <= q_slot[b]; the softmax is an
// f32 online softmax whose denominator is never zero.
//
// Bound on the H100: KV bytes (each int8 byte of the live cache is read once
// and feeds 2 flop per query row of its group). One block per (kv head,
// request) loads its `group` query rows once and walks the cache in tiles of
// 128 keys only over [valid_from, q_slot] -- the Hopper form of the TPU
// kernel's clamped index map: masked tiles are never read at all. Each tile
// is staged into shared memory with 16-byte coalesced loads (one key row of
// one head is d contiguous bytes), scores are one thread per key, and P@V is
// one thread per output dimension.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 128;      // keys per tile
constexpr int DMAX = 128;      // head_dim limit (d % 16 == 0)
constexpr int GMAX = 8;        // query heads per kv head limit
constexpr int KLD = DMAX + 16; // smem row stride (bytes): conflict-free 16B reads

__global__ void __launch_bounds__(THREADS)
int8_kv_decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kq,
    const float* __restrict__ ks, const int8_t* __restrict__ vq,
    const float* __restrict__ vs, const int* __restrict__ q_slot,
    const int* __restrict__ valid_from, __nv_bfloat16* __restrict__ out,
    int S, int Hq, int Hkv, int d, float scale) {
  __shared__ __align__(16) int8_t k_sm[TILE * KLD];
  __shared__ __align__(16) int8_t v_sm[TILE * KLD];
  __shared__ float q_sm[GMAX][DMAX];
  __shared__ float p_sm[GMAX][TILE];
  __shared__ float ks_sm[TILE];
  __shared__ float vs_sm[TILE];
  __shared__ float m_sm[GMAX], l_sm[GMAX], alpha_sm[GMAX];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = Hq / Hkv;
  const size_t row = (size_t)Hkv * d;             // bytes between keys
  const int8_t* kbase = kq + (size_t)b * S * row + (size_t)h * d;
  const int8_t* vbase = vq + (size_t)b * S * row + (size_t)h * d;
  const float* ksb = ks + ((size_t)b * Hkv + h) * S;
  const float* vsb = vs + ((size_t)b * Hkv + h) * S;
  __nv_bfloat16* ob = out + ((size_t)b * Hq + (size_t)h * group) * d;

  const int k_first = max(valid_from[b], 0);
  const int k_last = min(q_slot[b], S - 1);

  for (int i = tid; i < group * d; i += THREADS) {
    q_sm[i / d][i % d] =
        __bfloat162float(q[((size_t)b * Hq + (size_t)h * group) * d + i]);
  }
  if (tid < GMAX) {
    m_sm[tid] = -INFINITY;
    l_sm[tid] = 0.f;
  }
  float acc[GMAX];
#pragma unroll
  for (int r = 0; r < GMAX; ++r) acc[r] = 0.f;
  __syncthreads();

  const int cpk = d / 16;                          // 16-byte chunks per key
  for (int j0 = k_first; j0 <= k_last; j0 += TILE) {
    const int n = min(TILE, k_last - j0 + 1);
    for (int c = tid; c < n * cpk; c += THREADS) {
      const int key = c / cpk, part = c % cpk;
      const size_t off = (size_t)(j0 + key) * row + part * 16;
      *reinterpret_cast<uint4*>(&k_sm[key * KLD + part * 16]) =
          *reinterpret_cast<const uint4*>(kbase + off);
      *reinterpret_cast<uint4*>(&v_sm[key * KLD + part * 16]) =
          *reinterpret_cast<const uint4*>(vbase + off);
    }
    for (int t = tid; t < n; t += THREADS) {
      ks_sm[t] = ksb[j0 + t];
      vs_sm[t] = vsb[j0 + t];
    }
    __syncthreads();

    // scores: one thread per key, the k-scale lands on the score
    if (tid < n) {
      float dot[GMAX];
#pragma unroll
      for (int r = 0; r < GMAX; ++r) dot[r] = 0.f;
      for (int c0 = 0; c0 < d; c0 += 16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(&k_sm[tid * KLD + c0]);
        const int8_t* kv = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float kf = static_cast<float>(kv[e]);
#pragma unroll
          for (int r = 0; r < GMAX; ++r)
            if (r < group) dot[r] += q_sm[r][c0 + e] * kf;
        }
      }
      const float sk = ks_sm[tid] * scale;
#pragma unroll
      for (int r = 0; r < GMAX; ++r)
        if (r < group) p_sm[r][tid] = dot[r] * sk;
    }
    __syncthreads();

    // online softmax: one warp per query row; p is scaled by the v-scale
    for (int r = warp; r < group; r += THREADS / 32) {
      float mt = -INFINITY;
      for (int t = lane; t < n; t += 32) mt = fmaxf(mt, p_sm[r][t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = m_sm[r];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(p_sm[r][t] - m_new);
        sum += p;
        p_sm[r][t] = p * vs_sm[t];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);   // 0 on the first tile
        alpha_sm[r] = alpha;
        l_sm[r] = l_sm[r] * alpha + sum;
        m_sm[r] = m_new;
      }
    }
    __syncthreads();

    // P @ V: one thread per output dimension
    if (tid < d) {
#pragma unroll
      for (int r = 0; r < GMAX; ++r)
        if (r < group) acc[r] *= alpha_sm[r];
      for (int t = 0; t < n; ++t) {
        const float vf = static_cast<float>(v_sm[t * KLD + tid]);
#pragma unroll
        for (int r = 0; r < GMAX; ++r)
          if (r < group) acc[r] += p_sm[r][t] * vf;
      }
    }
    __syncthreads();
  }

  if (tid < d) {
#pragma unroll
    for (int r = 0; r < GMAX; ++r) {
      if (r < group) {
        const float l = l_sm[r];
        ob[(size_t)r * d + tid] = __float2bfloat16(acc[r] / (l > 0.f ? l : 1.f));
      }
    }
  }
}

}  // namespace

// q (B, Hq, d) bf16; k_q/v_q (B, S, Hkv*d) int8; k_s/v_s (B, Hkv, S) f32;
// q_slot/valid_from (B,) int32; out (B, Hq, d) bf16. All contiguous, the
// int8 rows 16-byte aligned, d % 16 == 0, d <= 128, Hq / Hkv <= 8 (checked
// by the Python wrapper). Returns cudaGetLastError().
extern "C" int pli_int8_kv_decode_attention(
    const void* q, const void* k_q, const void* k_s, const void* v_q,
    const void* v_s, const void* q_slot, const void* valid_from, void* out,
    int B, int S, int Hq, int Hkv, int d, float scale, void* stream) {
  dim3 grid(Hkv, B);
  int8_kv_decode_attention_kernel<<<grid, THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_q),
      static_cast<const float*>(k_s), static_cast<const int8_t*>(v_q),
      static_cast<const float*>(v_s), static_cast<const int*>(q_slot),
      static_cast<const int*>(valid_from), static_cast<__nv_bfloat16*>(out), S,
      Hq, Hkv, d, scale);
  return static_cast<int>(cudaGetLastError());
}
