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
// Three bodies; the wrapper picks one by dtype and shape and counts each:
//
// bf16 with 16-byte rows (K and N multiples of 8, aligned bases): Hopper's
// form, since only wgmma fed by TMA reaches the card's tensor-core rate. A
// 128 x 256 output tile a block of three warpgroups. One thread of the
// third keeps TMA loads of A (128 x 64) and B (64 x 256, four 64 x 64
// boxes) in flight through a 4-stage ring of 128-byte-swizzled shared
// memory, with a full and an empty mbarrier a stage; it gives its
// registers up (setmaxnreg). The first two each run wgmma m64n256k16 over
// their 64 rows, 128 f32 accumulators a thread, keeping one k-slice's
// wgmma in flight while the next is issued. A is K-major; B (K, N)
// row-major is MN-major, read with wgmma's transpose bit. TMA zero-fills
// boxes past M, N and K, so ragged shapes need no masks in the loads; the
// epilogue clips its stores.
//
// bf16 otherwise: tensor cores through WMMA (mma.sync m16n16k16, f32
// accumulate). A 128 x 128 output tile a block of 8 warps (each 64 x 32: 4
// x 2 fragments, 64 f32 accumulators a thread), K in slices of 32 staged in
// shared memory (rows padded by 8 elements against bank conflicts). The
// next slice is loaded into registers, 16 bytes a thread a load, while the
// tensor cores work on the current one (one-stage register prefetch). At
// the end each warp passes its fragments through a 16 x
// 16 f32 scratch in shared memory and writes them cast to the output dtype.
//
// f32: full f32 on the CUDA cores (no TF32, which wgmma would need): a 128
// x 128 tile a block of 256 threads, each thread an 8 x 8 register block, K
// in slices of 8; A is stored transposed in shared memory so a thread reads
// its 8 rows as two float4. The same register prefetch.
//
// The WMMA and f32 bodies mask ragged M, N and K with zeros (16-byte loads
// where a whole, aligned vector is in bounds, element loads elsewhere), so
// any shape is computed; the wrapper keeps the TPU kernel's divisibility
// check.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "wgmma.cuh"

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

// ---- bf16: wgmma fed by a TMA ring -----------------------------------------

constexpr int GBM = 128, GBN = 256, GBK = 64, STAGES = 4;
constexpr int G_THREADS = 384;                // warpgroups 0-1 consume, 2 loads
constexpr int A_BYTES = GBM * GBK * 2;        // 16 KB: 128 rows of 128 B
constexpr int B_BOX = GBK * 64 * 2;           // 8 KB: 64 K rows of 64 N (128 B)
constexpr int STAGE_BYTES = A_BYTES + (GBN / 64) * B_BOX;
constexpr int G_SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
// wgmma descriptor strides (bytes). A, K-major, 128-byte swizzle: 8-row
// groups 1024 B apart (the leading offset is unused). B, MN-major, 128-byte
// swizzle: 64-column atoms (one TMA box each) B_BOX apart, 8-row K groups
// 1024 B apart.
constexpr uint32_t A_LBO = 16, A_SBO = 1024, B_LBO = B_BOX, B_SBO = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}


__global__ void __launch_bounds__(G_THREADS, 1)
tiled_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                          const __grid_constant__ CUtensorMap tma_b, void* C,
                          int M, int N, int K, int out_bf16) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles need a 1024-byte aligned base
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int kt_n = (K + GBK - 1) / GBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);    // the loader's arrive, plus the TMA bytes
      mbar_init(empty(s), 8);   // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // loader: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);   // round 0 passes
        const uint32_t a = base + s * STAGE_BYTES;
        mbar_expect_tx(full(s), STAGE_BYTES);   // boxes past the edge count whole
        tma_load_2d(a, &tma_a, full(s), kt * GBK, m0);
#pragma unroll
        for (int j = 0; j < GBN / 64; ++j) {
          tma_load_2d(a + A_BYTES + j * B_BOX, &tma_b, full(s), n0 + j * 64, kt * GBK);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    const int lane = threadIdx.x & 31;
    for (int kt = 0; kt < kt_n; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full(s), (kt / STAGES) & 1);
      const uint32_t a = base + s * STAGE_BYTES + wg * 64 * 128;
      const uint32_t b = base + s * STAGE_BYTES + A_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < GBK / 16; ++kk) {
        // K-major A: the next 16 columns are 32 bytes on; MN-major B: the
        // next 16 K rows are 2048 bytes on
        wgmma_m64n256k16(d, gmma_desc(a + kk * 32, A_LBO, A_SBO),
                         gmma_desc(b + kk * 2048, B_LBO, B_SBO));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous slice's wgmma is done: hand its stage back
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");

    // epilogue: fragment i of warp w holds rows 16 w + g (+ 8 for i & 2),
    // columns 8 (i / 4) + 2 t + (i & 1); N % 8 == 0, so a pair is in or out
    const int w = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
    const int row0 = m0 + wg * 64 + w * 16 + g;
#pragma unroll
    for (int c = 0; c < GBN / 8; ++c) {
      const int col = n0 + c * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + half * 8;
        if (row >= M) continue;
        const size_t idx = (size_t)row * N + col;
        const float x0 = d[c * 4 + half * 2], x1 = d[c * 4 + half * 2 + 1];
        if (out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(C) + idx) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(C) + idx) = make_float2(x0, x1);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so the
// library links no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a (rows, cols) row-major bf16 matrix cut into boxes of box_rows x 64
// columns (128 bytes), 128-byte swizzled; boxes past the edge are zero-filled
bool encode_bf16(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K, int out_bf16,
                 cudaStream_t st) {
  CUtensorMap ma, mb;
  if (!encode_bf16(&ma, a, M, K, GBM) || !encode_bf16(&mb, b, K, N, GBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      tiled_matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  tiled_matmul_wgmma_kernel<<<grid, G_THREADS, G_SMEM, st>>>(ma, mb, c, M, N, K, out_bf16);
  return static_cast<int>(cudaGetLastError());
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

// A (M, K), B (K, N) contiguous; C (M, N) contiguous f32 (out_bf16 0) or
// bf16 (out_bf16 1). route 0: f32 A and B on the CUDA cores; 1: bf16 on
// WMMA; 2: bf16 on wgmma + TMA, which needs vec_a and vec_b. vec_a / vec_b =
// 1 when the rows of A / B may be read as 16-byte vectors (K / N a multiple
// of the vector's elements, the pointer 16-byte aligned). Returns
// cudaGetLastError(), or an error code where a tensor map cannot be made.
extern "C" int pli_tiled_matmul(const void* a, const void* b, void* c, int M,
                                int N, int K, int route, int out_bf16,
                                int vec_a, int vec_b, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    if (!vec_a || !vec_b) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma(a, b, c, M, N, K, out_bf16, st);
  }
  if (route == 1) {
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
