// K9: tiled GEMM, C = A @ B with f32 accumulation and one cast to the
// output dtype, for A (M, K) and B (K, N) both bf16 or both f32.
//
// Replaces the TPU kernel physics_llm_inference_tpu/kernels/matmul.py
// (tiled_matmul -> _matmul_kernel): a (M/bm, N/bn, K/bk) grid streaming A
// and B blocks through VMEM into the MXU, an f32 VMEM accumulator carried
// along the sequential K axis, the cast at the last K step.
//
// Bound on the H100: operations at the sizes it is run at (4096^3 bf16 does
// 1,365 flop per byte moved, the ridge is ~295). Blocks run in parallel and
// in no order, so the K axis is a loop inside the block and the accumulator
// lives in registers for the whole loop; nothing carries between blocks.
//
// bf16: tensor cores through WMMA (mma.sync m16n16k16, f32 accumulate). A
// 128 x 128 output tile a block of 8 warps (each 64 x 32: 4 x 2 fragments,
// 64 f32 accumulators a thread), K in slices of 32 staged in shared memory
// (rows padded by 8 elements against bank conflicts). The next slice is
// loaded into registers, 16 bytes a thread a load, while the tensor cores
// work on the current one (one-stage register prefetch, as w8a16_tile.cuh).
// At the end each warp passes its fragments through a 16 x 16 f32 scratch
// in shared memory and writes them cast to the output dtype.
//
// f32: full f32 on the CUDA cores (no TF32): a 128 x 128 tile a block of
// 256 threads, each thread an 8 x 8 register block, K in slices of 8; A is
// stored transposed in shared memory so a thread reads its 8 rows as two
// float4. The same register prefetch.
//
// Both mask ragged M, N and K with zeros (16-byte loads where a whole,
// aligned vector is in bounds, element loads elsewhere), so any shape is
// computed; the wrapper keeps the TPU kernel's divisibility check.
// wgmma, TMA and a multi-stage ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int THREADS = 256;

// ---- output ----------------------------------------------------------------

__device__ __forceinline__ void store_out(void* c, int out_bf16, size_t idx,
                                          float v) {
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(c)[idx] = __float2bfloat16(v);
  } else {
    static_cast<float*>(c)[idx] = v;
  }
}

// ---- bf16: WMMA ------------------------------------------------------------

constexpr int HBM = 128, HBN = 128, HBK = 32;
constexpr int A_LD = HBK + 8;   // bf16 elements
constexpr int B_LD = HBN + 8;

struct SmemBf16 {
  __nv_bfloat16 a[HBM * A_LD];  // A slice (HBM x HBK)
  __nv_bfloat16 b[HBK * B_LD];  // B slice (HBK x HBN)
};

struct StageBf16 {
  uint4 a[2];
  uint4 b[2];
};

__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* __restrict__ p,
                                            size_t row_off, int col, int ncols,
                                            bool row_ok, bool vec) {
  if (vec && row_ok && col + 8 <= ncols) {
    return __ldg(reinterpret_cast<const uint4*>(p + row_off + col));
  }
  __align__(16) unsigned short tmp[8];
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    tmp[e] = (row_ok && col + e < ncols) ? q[row_off + col + e]
                                         : static_cast<unsigned short>(0);
  }
  return *reinterpret_cast<const uint4*>(tmp);
}

__device__ __forceinline__ void load_stage_bf16(
    StageBf16& st, const __nv_bfloat16* __restrict__ A,
    const __nv_bfloat16* __restrict__ B, int M, int N, int K, int m0, int n0,
    int k0, bool vec_a, bool vec_b) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = threadIdx.x + i * THREADS;   // 512 chunks: 128 rows x 4
    const int row = id >> 2, col = (id & 3) * 8;
    const int gm = m0 + row;
    st.a[i] = load8_bf16(A, (size_t)gm * K, k0 + col, K, gm < M, vec_a);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = threadIdx.x + i * THREADS;   // 512 chunks: 32 rows x 16
    const int row = id >> 4, col = (id & 15) * 8;
    const int gk = k0 + row;
    st.b[i] = load8_bf16(B, (size_t)gk * N, n0 + col, N, gk < K, vec_b);
  }
}

__device__ __forceinline__ void store_stage_bf16(const StageBf16& st,
                                                 SmemBf16& sm) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = threadIdx.x + i * THREADS;
    const int row = id >> 2, col = (id & 3) * 8;
    *reinterpret_cast<uint4*>(&sm.a[row * A_LD + col]) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = threadIdx.x + i * THREADS;
    const int row = id >> 4, col = (id & 15) * 8;
    *reinterpret_cast<uint4*>(&sm.b[row * B_LD + col]) = st.b[i];
  }
}

__global__ void __launch_bounds__(THREADS, 2)   // two blocks an SM
tiled_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                         const __nv_bfloat16* __restrict__ B, void* C, int M,
                         int N, int K, int out_bf16, int vec_a, int vec_b) {
  __shared__ __align__(128) unsigned char smem_raw[sizeof(SmemBf16)];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;     // 2 x 4 warps, 64 x 32 each
  const int m0 = blockIdx.y * HBM, n0 = blockIdx.x * HBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  StageBf16 st;
  load_stage_bf16(st, A, B, M, N, K, m0, n0, 0, vec_a != 0, vec_b != 0);
  for (int k0 = 0; k0 < K; k0 += HBK) {
    store_stage_bf16(st, sm);
    __syncthreads();
    if (k0 + HBK < K) {
      load_stage_bf16(st, A, B, M, N, K, m0, n0, k0 + HBK, vec_a != 0,
                      vec_b != 0);
    }
#pragma unroll
    for (int kk = 0; kk < HBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::load_matrix_sync(fa[i], &sm.a[(wm * 64 + i * 16) * A_LD + kk],
                               A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb[j], &sm.b[kk * B_LD + wn * 32 + j * 16],
                               B_LD);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j],
                                                   acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp's fragments through its own 16 x 16 f32 scratch
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 64 + i * 16 + r;
      const int gn = n0 + wn * 32 + j * 16 + c0;
      if (gm < M) {
        const float* v = scratch + r * 16 + c0;
        const size_t base = (size_t)gm * N + gn;
        if (out_bf16 && gn + 8 <= N && (base & 7) == 0) {
          __align__(16) __nv_bfloat16 t[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) t[e] = __float2bfloat16(v[e]);
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(C) + base) =
              *reinterpret_cast<const uint4*>(t);
        } else {
          for (int e = 0; e < 8 && gn + e < N; ++e) {
            store_out(C, out_bf16, base + e, v[e]);
          }
        }
      }
      __syncwarp();
    }
  }
}

// ---- f32: register-blocked SIMT ---------------------------------------------

constexpr int FBM = 128, FBN = 128, FBK = 8;

struct StageF32 {
  float4 a;
  float4 b;
};

__device__ __forceinline__ float4 load4_f32(const float* __restrict__ p,
                                            size_t row_off, int col, int ncols,
                                            bool row_ok, bool vec) {
  if (vec && row_ok && col + 4 <= ncols) {
    return __ldg(reinterpret_cast<const float4*>(p + row_off + col));
  }
  float t[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    t[e] = (row_ok && col + e < ncols) ? p[row_off + col + e] : 0.f;
  }
  return make_float4(t[0], t[1], t[2], t[3]);
}

__device__ __forceinline__ void load_stage_f32(StageF32& st,
                                               const float* __restrict__ A,
                                               const float* __restrict__ B,
                                               int M, int N, int K, int m0,
                                               int n0, int k0, bool vec_a,
                                               bool vec_b) {
  const int tid = threadIdx.x;
  {  // A slice 128 x 8: 2 float4 a row
    const int row = tid >> 1, col = (tid & 1) * 4;
    const int gm = m0 + row;
    st.a = load4_f32(A, (size_t)gm * K, k0 + col, K, gm < M, vec_a);
  }
  {  // B slice 8 x 128: 32 float4 a row
    const int row = tid >> 5, col = (tid & 31) * 4;
    const int gk = k0 + row;
    st.b = load4_f32(B, (size_t)gk * N, n0 + col, N, gk < K, vec_b);
  }
}

__global__ void __launch_bounds__(THREADS)
tiled_matmul_f32_kernel(const float* __restrict__ A,
                        const float* __restrict__ B, void* C, int M, int N,
                        int K, int out_bf16, int vec_a, int vec_b) {
  __shared__ __align__(16) float as[FBK][FBM + 4];   // A slice, transposed
  __shared__ __align__(16) float bs[FBK][FBN + 4];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;            // 16 x 16 threads
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  StageF32 st;
  load_stage_f32(st, A, B, M, N, K, m0, n0, 0, vec_a != 0, vec_b != 0);
  for (int k0 = 0; k0 < K; k0 += FBK) {
    {
      const int row = tid >> 1, col = (tid & 1) * 4;
      as[col + 0][row] = st.a.x;
      as[col + 1][row] = st.a.y;
      as[col + 2][row] = st.a.z;
      as[col + 3][row] = st.a.w;
      const int brow = tid >> 5, bcol = (tid & 31) * 4;
      *reinterpret_cast<float4*>(&bs[brow][bcol]) = st.b;
    }
    __syncthreads();
    if (k0 + FBK < K) {
      load_stage_f32(st, A, B, M, N, K, m0, n0, k0 + FBK, vec_a != 0,
                     vec_b != 0);
    }
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][tx * 8 + 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty * 8 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx * 8 + j;
      if (gn < N) store_out(C, out_bf16, (size_t)gm * N + gn, acc[i][j]);
    }
  }
}

}  // namespace

// A (M, K), B (K, N) contiguous, both f32 (dtype 0) or both bf16 (dtype 1);
// C (M, N) contiguous f32 (out_bf16 0) or bf16 (out_bf16 1). vec_a / vec_b
// = 1 when the rows of A / B may be read as 16-byte vectors (K / N a
// multiple of the vector's elements, the pointer 16-byte aligned). Returns
// cudaGetLastError().
extern "C" int pli_tiled_matmul(const void* a, const void* b, void* c, int M,
                                int N, int K, int dtype, int out_bf16,
                                int vec_a, int vec_b, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid((N + HBN - 1) / HBN, (M + HBM - 1) / HBM);
    tiled_matmul_bf16_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), c, M, N, K, out_bf16, vec_a,
        vec_b);
  } else {
    dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    tiled_matmul_f32_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), c, M, N,
        K, out_bf16, vec_a, vec_b);
  }
  return static_cast<int>(cudaGetLastError());
}
