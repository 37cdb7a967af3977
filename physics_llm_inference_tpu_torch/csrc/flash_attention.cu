// K5: causal GQA flash attention for prefill.
//
// Replaces the TPU kernel physics_llm_inference_tpu/kernels/
// flash_attention.py (flash_attention -> _flash_kernel_v3 + _flash_finalize).
// Same contract: q (B, Hq, Sq, d), k/v (B, Hkv, Sk, d) bf16; key kpos is
// live for query i of request b iff kpos < kv_len, kpos >= valid_from[b] and
// (causal) kpos <= q_offset[b] + i; bf16 operands for QK^T and PV with f32
// accumulation; an f32 online softmax in base 2 (log2(e) folded into the
// scale); masked scores are -1e30, as in the TPU kernel, so a row with no
// live key in a tile stays finite; output in bf16, (B, Hq, Sq, d).
//
// Bound on the H100: tensor-core work at prefill sizes (4 * Sq * Sk * d flop
// per query head against 2 * Sk * d bytes of K/V per kv head). One block per
// (q tile, kv head, request) holds the whole GQA group's rows of its q tile
// -- group heads x (64 / group) positions, 64 rows -- so each K/V tile in
// shared memory feeds every head of the group, as the TPU kernel's grouped
// block does. The block walks only the live KV tiles, from the tile holding
// valid_from to the causal last one; tiles that are fully live skip the
// mask. Both products run on WMMA bf16 16x16x16 with f32 accumulators; each
// of the 4 warps owns 16 rows, so scores, probabilities and the output rows
// it rescales are private to the warp and only the K/V tile loads need the
// whole block. The output accumulator lives in shared memory because WMMA's
// accumulator layout is opaque, and the per-row rescale needs rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int THREADS = 128;   // 4 warps x 16 rows
constexpr int ROWS = 64;       // query rows of a block: (group head, position)
constexpr int BK = 64;         // keys per KV tile
constexpr int DMAX = 128;      // head_dim limit (d % 16 == 0)
constexpr int QLD = DMAX + 8;  // bf16 row stride of the Q/K/V tiles
constexpr int SLD = BK + 4;    // f32 row stride of the score tile
constexpr int PLD = BK + 8;    // bf16 row stride of the probability tile
constexpr int OLD = DMAX + 4;  // f32 row stride of the output accumulator
constexpr float NEG = -1e30f;

struct __align__(128) Smem {
  __nv_bfloat16 q[ROWS * QLD];
  __nv_bfloat16 k[BK * QLD];
  __nv_bfloat16 v[BK * QLD];
  float s[ROWS * SLD];
  __nv_bfloat16 p[ROWS * PLD];
  float o[ROWS * OLD];
  float m[ROWS];
  float l[ROWS];
  int qpos[ROWS];   // the row's query position in key space; -1: padding row
};

__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       const int* __restrict__ q_offset,
                       const int* __restrict__ valid_from, int Hq, int Hkv,
                       int Sq, int Sk, int d, int kv_len, int causal, int bq,
                       long long qsb, long long qsh, long long qss,
                       long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss,
                       float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * bq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = Hq / Hkv;
  const int rows = group * bq;            // rows in use (<= ROWS)
  const int nq = min(bq, Sq - q0);        // positions in this tile
  const int qoff = q_offset[b];
  const int vfrom = max(valid_from[b], 0);
  const int cpr = d / 8;                  // 16-byte chunks per row

  // Q tile: row r = j * bq + i is query head h * group + j at position q0 + i
  for (int c = tid; c < ROWS * cpr; c += THREADS) {
    const int r = c / cpr, part = c % cpr;
    const int j = r / bq, i = r % bq;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && i < nq) {
      val = *reinterpret_cast<const uint4*>(q + b * qsb + (long long)(h * group + j) * qsh +
                                            (long long)(q0 + i) * qss + part * 8);
    }
    *reinterpret_cast<uint4*>(&sm.q[r * QLD + part * 8]) = val;
  }
  for (int r = tid; r < ROWS; r += THREADS) {
    const int i = r % bq;
    sm.m[r] = NEG;
    sm.l[r] = 0.f;
    sm.qpos[r] = (r < rows && i < nq) ? qoff + q0 + i : -1;
  }
  for (int c = tid; c < ROWS * d; c += THREADS) sm.o[(c / d) * OLD + c % d] = 0.f;

  // live KV tiles: from the one holding valid_from to the causal last one
  int k_end = kv_len;
  if (causal) k_end = min(k_end, qoff + q0 + nq);
  const int t_first = vfrom / BK;
  const int t_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  const int r0 = warp * 16;

  for (int t = t_first; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's K/V are no longer read
    for (int c = tid; c < BK * cpr; c += THREADS) {
      const int key = c / cpr, part = c % cpr;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + key < Sk) {
        kv = *reinterpret_cast<const uint4*>(k + b * ksb + (long long)h * ksh +
                                             (long long)(k0 + key) * kss + part * 8);
        vv = *reinterpret_cast<const uint4*>(v + b * vsb + (long long)h * vsh +
                                             (long long)(k0 + key) * vss + part * 8);
      }
      *reinterpret_cast<uint4*>(&sm.k[key * QLD + part * 8]) = kv;
      *reinterpret_cast<uint4*>(&sm.v[key * QLD + part * 8]) = vv;
    }
    __syncthreads();
    // a tile below the diagonal for the tile's first query, inside kv_len
    // and past valid_from needs no mask
    const bool full = k0 >= vfrom && k0 + BK <= kv_len &&
                      (!causal || k0 + BK - 1 <= qoff + q0);

    // S = Q K^T for this warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
      for (int kk = 0; kk < d; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, &sm.q[r0 * QLD + kk], QLD);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, &sm.k[(j * 16) * QLD + kk], QLD);
          wmma::mma_sync(sacc[j], fa, fb, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(&sm.s[r0 * SLD + j * 16], sacc[j], SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time, two keys per lane
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      float s0 = sm.s[r * SLD + lane] * scale_log2;
      float s1 = sm.s[r * SLD + lane + 32] * scale_log2;
      if (!full) {
        const int qp = sm.qpos[r];
        const int kp0 = k0 + lane, kp1 = k0 + lane + 32;
        if (!(kp0 < kv_len && kp0 >= vfrom && (!causal || kp0 <= qp))) s0 = NEG;
        if (!(kp1 < kv_len && kp1 >= vfrom && (!causal || kp1 <= qp))) s1 = NEG;
      }
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, mt);
      const float alpha = exp2f(m_old - m_new);
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      sm.p[r * PLD + lane] = __float2bfloat16(p0);
      sm.p[r * PLD + lane + 32] = __float2bfloat16(p1);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      for (int c = lane; c < d; c += 32) sm.o[r * OLD + c] *= alpha;
      if (lane == 0) {
        sm.l[r] = sm.l[r] * alpha + sum;
        sm.m[r] = m_new;
      }
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fp[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(fp[kk], &sm.p[r0 * PLD + kk * 16], PLD);
      for (int j = 0; j < d / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
        wmma::load_matrix_sync(oacc, &sm.o[r0 * OLD + j * 16], OLD, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fv;
          wmma::load_matrix_sync(fv, &sm.v[(kk * 16) * QLD + j * 16], QLD);
          wmma::mma_sync(oacc, fp[kk], fv, oacc);
        }
        wmma::store_matrix_sync(&sm.o[r0 * OLD + j * 16], oacc, OLD, wmma::mem_row_major);
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // finalize: divide by the denominator (a row with none keeps 0)
  for (int c = tid; c < rows * d; c += THREADS) {
    const int r = c / d, col = c % d;
    const int j = r / bq, i = r % bq;
    if (i >= nq) continue;
    const float l = sm.l[r];
    out[(((long long)b * Hq + h * group + j) * Sq + q0 + i) * d + col] =
        __float2bfloat16(sm.o[r * OLD + col] / (l > 0.f ? l : 1.f));
  }
}

}  // namespace

// q (B, Hq, Sq, d), k/v (B, Hkv, Sk, d) bf16 with the given element strides
// of their first three axes (the last axis contiguous, rows 16-byte
// aligned); out (B, Hq, Sq, d) bf16 contiguous; q_offset/valid_from (B,)
// int32. d % 16 == 0, d <= 128, Hq / Hkv <= 64 (checked by the Python
// wrapper). Returns the launch's error code.
extern "C" int pli_flash_attention(
    const void* q, const void* k, const void* v, void* out,
    const void* q_offset, const void* valid_from, int B, int Hq, int Hkv,
    int Sq, int Sk, int d, int kv_len, int causal, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale_log2,
    void* stream) {
  const int bq = ROWS / (Hq / Hkv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + bq - 1) / bq, Hkv, B);
  flash_attention_kernel<<<grid, THREADS, sizeof(Smem),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(q_offset), static_cast<const int*>(valid_from), Hq,
      Hkv, Sq, Sk, d, kv_len, causal, bq, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh,
      vss, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
