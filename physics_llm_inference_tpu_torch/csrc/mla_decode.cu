// MLA decode attention: the absorbed form of multi-head latent attention
// (DeepSeek-V2, arXiv:2405.04434) for one new token a request, over the
// INT8 latent cache (models/mla.py).
//
// Replaces no TPU kernel: the JAX package has no latent attention.
// Contract: q (B, 16, 576) bf16, each head's absorbed query (512 latent
// dims, then 64 rope dims); the cache row of request b is codes (S, 576)
// int8 (the latent's 512 codes, then the rope key's 64) and scales (2, S)
// f32 (the latent's, then the rope key's); key k is live for request b iff
// valid_from[b] <= k <= q_slot[b]. score = (q_lat . c_k * s_c[k] +
// q_pe . pe_k * s_p[k]) * scale, an f32 softmax over the live keys, and the
// output is sum_k p_k * c_k * s_c[k], (B, 16, 512) in bf16: the value is
// the latent itself, shared by the 16 query heads.
//
// Bound on the H100: the live cache bytes (584 a key), each read once.
// At 16 heads a key costs 16 x (576 + 512) x 2 flops, ~60 a byte: below
// the tensor cores' ridge (~295) but far above the CUDA cores' (~20), so
// both products run on mma.sync m16n8k16 (bf16, f32 accumulation), the 16
// heads being the mma's 16 rows. Design:
// - grid (splits, B): a request's live keys are cut into `splits` equal
//   runs of 64-key tiles (flash decoding), so B x splits blocks keep every
//   SM busy at small batches; each block leaves its un-normalised output,
//   running max and sum in a workspace, and a second launch merges them;
// - a block's tiles stream through a two-stage cp.async ring (16-byte
//   copies of the 576-byte rows, 4-byte copies of the scales; keys past
//   the run zero-filled): tile t + 1 is in flight while tile t computes;
// - each tile's int8 codes are widened once to a bf16 tile in shared
//   memory (exact: |x| <= 127), which both products read by ldmatrix:
//   scores S = Q K^T (warp w: keys 8w..8w+7 over the 576 dims, the latent's
//   and the rope key's sums kept apart for their scales), then the online
//   softmax over the tile in shared memory (16 threads a head), then
//   O += P' V with P' = p * s_c rounded to bf16 (the value scale folded
//   into the probability, as K2/K4 fold theirs) and V the tile's latent
//   codes (warp w: output dims 64w..64w+63, ldmatrix.trans);
// - shared rows are padded by 16 bytes, so ldmatrix's row addresses fall
//   in distinct banks. ~175 KB of shared memory: one block an SM.
// Every sum runs in a fixed order, so two launches are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H = 16;            // query heads: the mma's M
constexpr int R = 512;           // latent width: the value
constexpr int DR = 64;           // rope key width
constexpr int W = R + DR;        // a cache row's codes
constexpr int BK = 64;           // keys a tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDQ = W + 8;       // bf16 row stride of Q and the widened tile
constexpr int LDP = BK + 8;      // bf16 row stride of P'
constexpr int LDS = BK + 4;      // f32 row stride of the scores
constexpr int OUT_W = R / WARPS; // output dims a warp: 64
constexpr float NEG = -1e30f;

struct __align__(128) Smem {
  __nv_bfloat16 q[H * LDQ];
  __nv_bfloat16 kt[BK * LDQ];     // the tile widened to bf16
  int8_t raw[2][BK * W];          // the ring of int8 tiles
  float sc[2][2][BK];             // their scales: latent, rope key
  float s[H * LDS];               // the tile's scores (log2 units)
  __nv_bfloat16 p[H * LDP];       // P' = p * s_c
  float m_run[H], l_run[H], alpha[H];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Byte j of the word wx = w ^ 0x80808080 as the exact f32 of w's int8 byte
// j: the byte under the exponent of 2^23, less 2^23 + 128.
__device__ __forceinline__ float byte_f32(uint32_t wx, int j) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7650 | j)) - 8388736.f;
}

// Four int8 codes as two bf16 pairs.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t wx = w ^ 0x80808080u;
  return make_uint2(pack_bf16(byte_f32(wx, 0), byte_f32(wx, 1)),
                    pack_bf16(byte_f32(wx, 2), byte_f32(wx, 3)));
}

__global__ void __launch_bounds__(THREADS, 1)
mla_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                        const int8_t* __restrict__ codes,
                        const float* __restrict__ scales,
                        const int* __restrict__ q_slot,
                        const int* __restrict__ valid_from,
                        float* __restrict__ ws_o, float* __restrict__ ws_ml, int S,
                        float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int split = blockIdx.x, splits = gridDim.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  // this block's run of the live keys [lo, hi): equal runs of whole tiles
  const int lo = max(valid_from[b], 0);
  const int hi = min(q_slot[b] + 1, S);
  const int tiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  const int per = (tiles + splits - 1) / splits;
  const int t_first = split * per, t_end = min(tiles, t_first + per);
  const int k_begin = lo + t_first * BK;
  const int k_end = min(hi, lo + t_end * BK);

  const int8_t* cb = codes + (long long)b * S * W;
  const float* sb = scales + (long long)b * 2 * S;
  auto load = [&](int t, int stage) {
    const int k0 = lo + t * BK;
    for (int c = tid; c < BK * (W / 16); c += THREADS) {
      const int key = c / (W / 16), part = c % (W / 16);
      const bool in = k0 + key < k_end;
      const long long kp = in ? k0 + key : 0;
      cp16(&sm.raw[stage][key * W + part * 16], cb + kp * W + part * 16, in ? 16 : 0);
    }
    if (tid < 2 * BK) {
      const int part = tid / BK, key = tid % BK;
      const bool in = k0 + key < k_end;
      cp4(&sm.sc[stage][part][key], sb + (long long)part * S + (in ? k0 + key : 0),
          in ? 4 : 0);
    }
  };

  for (int c = tid; c < H * (W / 8); c += THREADS) {
    const int r = c / (W / 8), part = c % (W / 8);
    cp16(&sm.q[r * LDQ + part * 8], q + ((long long)b * H + r) * W + part * 8, 16);
  }
  if (tid < H) {
    sm.m_run[tid] = NEG;
    sm.l_run[tid] = 0.f;
  }
  if (t_first < t_end) load(t_first, 0);
  cp_commit();

  float o[OUT_W / 8][4];
#pragma unroll
  for (int j = 0; j < OUT_W / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  // ldmatrix row addresses of this lane
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;           // Q, P' (A)
  const int k_row = lane & 7, k_col = ((lane >> 3) & 1) * 8;      // K (B, x2)
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;  // V (B, trans)

  for (int t = t_first; t < t_end; ++t) {
    const int stage = (t - t_first) & 1;
    const int k0 = lo + t * BK;
    cp_wait<0>();
    __syncthreads();   // tile t landed; the last tile's readers are done
    if (t + 1 < t_end) load(t + 1, stage ^ 1);
    cp_commit();

    // widen the tile's codes: 8 bytes -> 8 bf16 a step
    for (int c = tid; c < BK * (W / 8); c += THREADS) {
      const int key = c / (W / 8), part = c % (W / 8);
      const uint2 w = *reinterpret_cast<const uint2*>(&sm.raw[stage][key * W + part * 8]);
      const uint2 lo4 = widen4(w.x), hi4 = widen4(w.y);
      *reinterpret_cast<uint4*>(&sm.kt[key * LDQ + part * 8]) =
          make_uint4(lo4.x, lo4.y, hi4.x, hi4.y);
    }
    __syncthreads();

    // scores of keys 8w..8w+7: the latent's sum and the rope key's apart
    {
      float acc_c[4] = {0.f, 0.f, 0.f, 0.f}, acc_p[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* kb = &sm.kt[(warp * 8 + k_row) * LDQ + k_col];
#pragma unroll 8
      for (int kk = 0; kk < R / 16; ++kk) {
        uint32_t a[4], bk[2];
        ldsm_x4(a, &sm.q[a_row * LDQ + kk * 16 + a_col]);
        ldsm_x2(bk, kb + kk * 16);
        mma16816(acc_c, a, bk[0], bk[1]);
      }
#pragma unroll
      for (int kk = R / 16; kk < W / 16; ++kk) {
        uint32_t a[4], bk[2];
        ldsm_x4(a, &sm.q[a_row * LDQ + kk * 16 + a_col]);
        ldsm_x2(bk, kb + kk * 16);
        mma16816(acc_p, a, bk[0], bk[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = warp * 8 + 2 * t4 + (e & 1);
        const int kp = k0 + key;
        float x = (acc_c[e] * sm.sc[stage][0][key] + acc_p[e] * sm.sc[stage][1][key]) *
                  scale_log2;
        if (kp < k_begin || kp >= k_end) x = NEG;
        sm.s[(g + (e >> 1) * 8) * LDS + key] = x;
      }
    }
    __syncthreads();

    // online softmax over the tile: 16 threads a head, 4 keys each
    {
      const int r = tid >> 4, q4 = tid & 15;
      float x[4];
      float mt = NEG;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = sm.s[r * LDS + q4 * 4 + i];
        mt = fmaxf(mt, x[i]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = sm.m_run[r];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      uint32_t pk[2];
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const float p0 = exp2f(x[i] - m_new), p1 = exp2f(x[i + 1] - m_new);
        sum += p0 + p1;
        pk[i / 2] = pack_bf16(p0 * sm.sc[stage][0][q4 * 4 + i],
                              p1 * sm.sc[stage][0][q4 * 4 + i + 1]);
      }
      *reinterpret_cast<uint2*>(&sm.p[r * LDP + q4 * 4]) = make_uint2(pk[0], pk[1]);
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (q4 == 0) {
        const float alpha = exp2f(m_old - m_new);
        sm.alpha[r] = alpha;
        sm.l_run[r] = sm.l_run[r] * alpha + sum;
        sm.m_run[r] = m_new;
      }
    }
    __syncthreads();

    // O += P' V over this warp's 64 output dims
    {
      const float a0 = sm.alpha[g], a1 = sm.alpha[g + 8];
#pragma unroll
      for (int j = 0; j < OUT_W / 8; ++j) {
        o[j][0] *= a0;
        o[j][1] *= a0;
        o[j][2] *= a1;
        o[j][3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, &sm.p[a_row * LDP + kk * 16 + a_col]);
#pragma unroll
        for (int j = 0; j < OUT_W / 8; j += 2) {
          uint32_t bv[4];
          ldsm_x4_t(bv, &sm.kt[(kk * 16 + v_row) * LDQ + warp * OUT_W + j * 8 + v_col]);
          mma16816(o[j], a, bv[0], bv[1]);
          mma16816(o[j + 1], a, bv[2], bv[3]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // this run's un-normalised output, max and sum
  float* wo = ws_o + ((long long)b * splits + split) * H * R;
#pragma unroll
  for (int j = 0; j < OUT_W / 8; ++j) {
    const int col = warp * OUT_W + j * 8 + 2 * t4;
    *reinterpret_cast<float2*>(&wo[g * R + col]) = make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(&wo[(g + 8) * R + col]) = make_float2(o[j][2], o[j][3]);
  }
  if (tid < H) {
    float* ml = ws_ml + (((long long)b * splits + split) * H + tid) * 2;
    ml[0] = sm.m_run[tid];
    ml[1] = sm.l_run[tid];
  }
}

// Merge the runs of request blockIdx.y, head blockIdx.x: 128 threads, 4
// output dims each, the runs in order.
__global__ void __launch_bounds__(128)
mla_decode_combine_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
                          __nv_bfloat16* __restrict__ out, int splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x * 4;
  float m = NEG;
  for (int j = 0; j < splits; ++j) m = fmaxf(m, ws_ml[(((long long)b * splits + j) * H + h) * 2]);
  float l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < splits; ++j) {
    const float* ml = ws_ml + (((long long)b * splits + j) * H + h) * 2;
    if (ml[1] == 0.f) continue;   // a run with no live key
    const float w = exp2f(ml[0] - m);
    l += w * ml[1];
    const float4 v =
        *reinterpret_cast<const float4*>(ws_o + (((long long)b * splits + j) * H + h) * R + d);
    acc[0] += w * v.x;
    acc[1] += w * v.y;
    acc[2] += w * v.z;
    acc[3] += w * v.w;
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  __nv_bfloat16* dst = out + ((long long)b * H + h) * R + d;
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(acc[0] * inv, acc[1] * inv), pack_bf16(acc[2] * inv, acc[3] * inv));
}

}  // namespace

// q (B, 16, 576) bf16, codes (B, S, 576) int8, scales (B, 2, S) f32,
// q_slot/valid_from (B,) int32, out (B, 16, 512) bf16, all contiguous;
// ws_o (B, splits, 16, 512) and ws_ml (B, splits, 16, 2) f32 workspaces.
// Two launches. Returns the first error code.
extern "C" int pli_mla_decode(const void* q, const void* codes, const void* scales,
                              const void* q_slot, const void* valid_from, void* out,
                              void* ws_o, void* ws_ml, int B, int S, int splits,
                              float scale_log2, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(mla_decode_split_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mla_decode_split_kernel<<<dim3(splits, B), THREADS, sizeof(Smem), st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const int*>(q_slot),
      static_cast<const int*>(valid_from), static_cast<float*>(ws_o),
      static_cast<float*>(ws_ml), S, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_decode_combine_kernel<<<dim3(H, B), 128, 0, st>>>(
      static_cast<const float*>(ws_o), static_cast<const float*>(ws_ml),
      static_cast<__nv_bfloat16*>(out), splits);
  return static_cast<int>(cudaGetLastError());
}
