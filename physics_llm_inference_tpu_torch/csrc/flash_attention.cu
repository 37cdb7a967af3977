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
// Bound on the H100: bytes at the prefill shapes (Q and the output, and
// K/V once; at mma.sync's rate the causal work takes about as long as the
// bytes, and the two overlap only across the two blocks an SM). The design
// is FlashAttention-2's:
// - one block per (q tile, kv head, request) holds the whole GQA group's
//   rows of its q tile -- group heads x (128 / group) positions, 128 rows --
//   so each K/V tile in shared memory feeds every head of the group, as the
//   TPU kernel's grouped block does; 8 warps, each owning one m16 block of
//   16 rows;
// - both products run on mma.sync.m16n8k16 bf16 with f32 accumulators, fed
//   by ldmatrix (ldmatrix.trans for V). S = QK^T, the probabilities and the
//   output stay in registers: the accumulator layout of m16n8k16 puts a
//   thread on rows g and g + 8 and two adjacent columns, so two adjacent n8
//   score tiles, packed to bf16, are the A fragment of one k16 slice of PV,
//   and the row max and sum are reduced over the thread quad;
// - K/V tiles of 32 keys stream through a two-stage cp.async ring: tile
//   t + 1's 16-byte copies are in flight while tile t's products and
//   softmax run; keys past Sk are zero-filled by the copy itself. Shared
//   rows are padded by 16 bytes, so ldmatrix's eight row addresses fall in
//   distinct banks. 70 KB of shared memory and <= 128 registers a thread:
//   two blocks an SM;
// - head_dim is a template parameter (d / 16), so the product loops unroll
//   whole and ldmatrix loads are scheduled ahead of the MMAs;
// - the block walks only the live KV tiles, from the tile holding
//   valid_from to the causal last one; fully live tiles skip the mask;
// - the grid puts the q tile on its slowest axis, reversed, so the causal
//   last tiles (the most KV tiles) start first and the last wave is short.
// Every sum runs in a fixed order, so two launches are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 16;  // query rows of a block: (group head, position)
constexpr int BK = 32;            // keys per KV tile
constexpr int DMAX = 128;         // head_dim limit (d % 16 == 0)
constexpr int LD = DMAX + 8;      // bf16 row stride of the Q/K/V tiles (+16 B)
constexpr int NT = BK / 8;        // n8 score tiles of a KV tile
constexpr float NEG = -1e30f;

struct __align__(128) Smem {
  __nv_bfloat16 q[ROWS * LD];
  __nv_bfloat16 k[2][BK * LD];
  __nv_bfloat16 v[2][BK * LD];
  int qpos[ROWS];   // the row's query position in key space; -1: padding row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
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

template <int KD>   // d / 16
__global__ void __launch_bounds__(THREADS, 2)   // two blocks an SM
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       const int* __restrict__ q_offset,
                       const int* __restrict__ valid_from, int Hq, int Hkv,
                       int Sq, int Sk, int kv_len, int causal, int bq,
                       long long qsb, long long qsh, long long qss,
                       long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss,
                       float scale_log2) {
  constexpr int d = KD * 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  // the q tile is the grid's slowest axis, reversed: the causal last
  // (heaviest) tiles of every (kv head, request) start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * bq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;              // mma fragment coordinates
  const int group = Hq / Hkv;
  const int rows = group * bq;            // rows in use (<= ROWS)
  const int nq = min(bq, Sq - q0);        // positions in this tile
  const int qoff = q_offset[b];
  const int vfrom = max(valid_from[b], 0);
  constexpr int DT = d / 8;   // n8 tiles of the output, 16-byte chunks of a row

  // live KV tiles: from the one holding valid_from to the causal last one
  int k_end = kv_len;
  if (causal) k_end = min(k_end, qoff + q0 + nq);
  const int t_first = vfrom / BK;
  const int t_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  const __nv_bfloat16* kb = k + b * ksb + (long long)h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + (long long)h * vsh;
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * BK;
    for (int c = tid; c < BK * DT; c += THREADS) {
      const int key = c / DT, part = c % DT;
      const bool in = k0 + key < Sk;
      const long long kp = in ? k0 + key : 0;
      cp16(&sm.k[stage][key * LD + part * 8], kb + kp * kss + part * 8, in ? 16 : 0);
      cp16(&sm.v[stage][key * LD + part * 8], vb + kp * vss + part * 8, in ? 16 : 0);
    }
  };

  // Q tile: row r = j * bq + i is query head h * group + j at position q0 + i
  for (int c = tid; c < ROWS * DT; c += THREADS) {
    const int r = c / DT, part = c % DT;
    const int j = r / bq, i = r % bq;
    const bool in = r < rows && i < nq;
    const __nv_bfloat16* src =
        in ? q + b * qsb + (long long)(h * group + j) * qsh + (long long)(q0 + i) * qss + part * 8
           : q;
    cp16(&sm.q[r * LD + part * 8], src, in ? 16 : 0);
  }
  for (int r = tid; r < ROWS; r += THREADS) {
    const int i = r % bq;
    sm.qpos[r] = (r < rows && i < nq) ? qoff + q0 + i : -1;
  }
  if (t_first < t_end) load_kv(t_first, 0);
  cp_commit();

  // this warp's 16 rows from r0; a thread holds rows g and g + 8 (rr 0, 1)
  const int r0 = warp * 16;
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {NEG, NEG};   // running max
  float l_run[2] = {0.f, 0.f};   // this thread's share of the running sum
  __syncthreads();               // qpos
  const int qp[2] = {sm.qpos[r0 + g], sm.qpos[r0 + g + 8]};

  // ldmatrix row addresses of this lane (see the fragment layouts above)
  const int a_row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;

  for (int t = t_first; t < t_end; ++t) {
    const int stage = (t - t_first) & 1;
    const int k0 = t * BK;
    if (t + 1 < t_end) {
      load_kv(t + 1, stage ^ 1);   // in flight during this tile's math
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = sm.k[stage];
    const __nv_bfloat16* vs = sm.v[stage];

    // S = Q K^T for this warp's 16 rows and the tile's keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, &sm.q[a_row * LD + kk * 16 + a_col]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk[4];   // keys 8j..8j+15, d kk*16..+15
        ldsm_x4(bk, &ks[(j * 8 + k_row) * LD + kk * 16 + k_col]);
        mma16816(s[j], a, bk[0], bk[1]);
        mma16816(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // a tile below the diagonal for the tile's first query, inside kv_len
    // and past valid_from needs no mask
    const bool full = k0 >= vfrom && k0 + BK <= kv_len &&
                      (!causal || k0 + BK - 1 <= qoff + q0);
    float mt[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!full) {
          const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
          if (!(kp < kv_len && kp >= vfrom && (!causal || kp <= qp[e >> 1]))) x = NEG;
        }
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 1));
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 2));
      const float m_new = fmaxf(m_run[rr], mt[rr]);   // before any exp2
      alpha[rr] = exp2f(m_run[rr] - m_new);
      m_run[rr] = m_new;
      l_run[rr] *= alpha[rr];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // P = exp2(S - m) in f32 for the sum, packed to bf16 as PV's A operand:
    // score tile 2m -> a0 (row g), a1 (row g + 8); tile 2m + 1 -> a2, a3
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = exp2f(s[j][0] - m_run[0]), p1 = exp2f(s[j][1] - m_run[0]);
      const float p2 = exp2f(s[j][2] - m_run[1]), p3 = exp2f(s[j][3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      p[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t bv[4];   // keys kk*16..+15, d 8j..8j+15
        ldsm_x4_t(bv, &vs[(kk * 16 + v_row) * LD + j * 8 + v_col]);
        mma16816(o[j], p[kk], bv[0], bv[1]);
        mma16816(o[j + 1], p[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();   // this stage is refilled by the next iteration's copy
  }
  cp_wait<0>();        // a block with no live tile still has its Q copy
  __syncthreads();

  // finalize: the quad's shares of the denominator, divide (a row with none
  // keeps 0), stage the warp's rows in its own Q rows, write 16 bytes a lane
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_run[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[rr] = 1.f / (l > 0.f ? l : 1.f);
  }
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(&sm.q[(r0 + g) * LD + col]) =
        pack_bf16(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(&sm.q[(r0 + g + 8) * LD + col]) =
        pack_bf16(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * DT; c += 32) {
    const int r = r0 + c / DT, part = c % DT;
    const int j = r / bq, i = r % bq;
    if (r >= rows || i >= nq) continue;
    *reinterpret_cast<uint4*>(out + (((long long)b * Hq + h * group + j) * Sq + q0 + i) * d +
                              part * 8) =
        *reinterpret_cast<const uint4*>(&sm.q[r * LD + part * 8]);
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
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                 __nv_bfloat16*, const int*, const int*, int, int, int, int, int, int,
                 int, long long, long long, long long, long long, long long, long long,
                 long long, long long, long long, float);
  switch (d) {
    case 16: kernel = flash_attention_kernel<1>; break;
    case 32: kernel = flash_attention_kernel<2>; break;
    case 48: kernel = flash_attention_kernel<3>; break;
    case 64: kernel = flash_attention_kernel<4>; break;
    case 80: kernel = flash_attention_kernel<5>; break;
    case 96: kernel = flash_attention_kernel<6>; break;
    case 112: kernel = flash_attention_kernel<7>; break;
    case 128: kernel = flash_attention_kernel<8>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Hkv, B, (Sq + bq - 1) / bq);
  kernel<<<grid, THREADS, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(q_offset), static_cast<const int*>(valid_from), Hq, Hkv, Sq, Sk,
      kv_len, causal, bq, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
