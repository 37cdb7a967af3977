// Grouped W8A16 expert products of an MoE layer's decode step: hidden =
// bf16(silu(x @ w1 * s1) * (x @ w3 * s3)), then out = bf16(hidden @ w2 *
// s2), for every expert of the (E, C, D) slot grid at once.
//
// Replaces no TPU kernel: the JAX package computes the expert products
// outside Pallas (models/moe.py's einsums over dequantized stacks). The
// routed FFN's other path (models/moe.py: each INT8 stack dequantized to a
// bf16 copy, then torch.bmm on the copies), which prefill keeps, moves ~7 GB
// a layer at Mixtral's widths (1.41 G int8 weights read, 2.82 GB of bf16
// written and read back) where 1.41 GB is compulsory.
//
// Bound on the H100: the expert weight bytes. At C <= 64 slots an expert
// each int8 byte feeds at most 128 operations, far below the ~295 flop/byte
// bf16 ridge; 1.409 GB a layer at E 8, D 4096, F 14336 is 0.42 ms at 3.35
// TB/s. The design streams each byte once and writes no copy of a stack:
//  - It is w8a16_stream.cuh's weight stream (the producer/consumer loop of
//    K1's stream route and K4's GEMM phases) over the (E, K, N) stacks as
//    the (L, K, row-bytes) tensor map K4 streams over layers, with L the
//    expert. A unit is (expert, slab, k-tile): the plan
//    (kernels/w8a16_stream.plan over E m-blocks of 64 rows) makes the
//    expert the m-block, so stream-K splits all experts' units evenly over
//    one launch of one block an SM and no expert's tail idles SMs.
//  - Only routed slots are worked on. An expert's n_e live rows (the caller's
//    count of the pairs routed to it, at most C) are slot rows 0..n_e-1, so a
//    unit's x chunk is ceil(n_e / 16) boxes of 16 slot rows from a 3-D map
//    over (E, C, K), zero-filled past C by TMA, the consumers run that many
//    m16 tiles, and partials are stored for rows below n_e alone. At
//    DeepSeek-V2-Lite's ~6 rows an expert (C 64) that is one m16 tile of
//    four and a tenth of the partials; the weight stream, the plan and the
//    order of every live row's sums are those of the full grid.
//  - Launch A streams w1 and w3 in one plan: its slabs are w1's, then
//    w3's (two tensor maps); launch B streams w2 over hidden. Each writes
//    f32 partials, and a second kernel sums a column's partials in index
//    order (deterministic), applies the per-channel f32 scales to the sum
//    and, after launch A, forms silu(h1) * h3 in f32 with one rounding to
//    bf16. So no weight is rounded: the scales apply to f32 sums. The
//    finalize reads live rows' partials only; after launch A it leaves dead
//    rows of the hidden grid unwritten (launch B never stores their
//    products), after launch B it writes +0 there.
//  - Block 0 of the stream adds the live m16 tiles, sum of ceil(n_e / 16),
//    and all of them, E ceil(C / 16), to a two-word device counter.
// The kernels' names must not contain the strings the benchmark's FFN
// region ends or starts at (its K1, K2 and K3 kernels).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "w8a16_stream.cuh"

namespace {

using w8s::W8A16;
using G = w8s::Geo<W8A16>;

constexpr size_t STREAM_SMEM = 1024 + G::RING_BYTES;

// Slot rows a box of a unit's x chunk: one m16 tile.
constexpr int BOX_ROWS = 16;
constexpr int BOX_BYTES = BOX_ROWS * w8s::KT * 2;

// Expert e's live slot rows: its routed pairs, clamped to [0, C].
static __device__ __forceinline__ int live_rows(const long long* counts, int e, int C) {
  const long long n = __ldg(counts + e);
  return static_cast<int>(n < 0 ? 0 : n > C ? C : n);
}

// The m16 tiles that hold live rows, 0 to 4, as a template parameter
// (w8s::with_live_tiles' form, with 0 for an expert nobody was routed to).
template <class Body>
static __device__ __forceinline__ void with_slot_tiles(int rows, Body body) {
  switch ((rows + BOX_ROWS - 1) / BOX_ROWS) {
    case 0: body(std::integral_constant<int, 0>()); break;
    case 1: body(std::integral_constant<int, 1>()); break;
    case 2: body(std::integral_constant<int, 2>()); break;
    case 3: body(std::integral_constant<int, 3>()); break;
    default: body(std::integral_constant<int, 4>()); break;
  }
}

// The weight producer: this block's units, each a KT x SLAB tile of expert
// e's stack (stack_slabs slabs of NW-byte rows each; slabs past those come
// from the second stack `wb`).
static __device__ __forceinline__ void produce_weights(const w8s::Plan& pl, const CUtensorMap* wa,
                                                       const CUtensorMap* wb, int NW,
                                                       int stack_slabs,
                                                       const w8s::Ring<W8A16>& r) {
  if (static_cast<int>(blockIdx.x) >= pl.blocks) return;
  const int t1 = w8s::first_tile(pl, blockIdx.x + 1);
  uint32_t it = 0;
  for (int t = w8s::first_tile(pl, blockIdx.x); t < t1; ++t, ++it) {
    const int s = it % G::STAGES;
    w8s::mbar_wait(r.empty(s), ((it / G::STAGES) & 1) ^ 1);   // round 0 passes
    const int u = t / pl.ktn, slab = u % pl.slabs, e = u / pl.slabs;
    const int n0 = (slab % stack_slabs) * G::SLAB, k0 = (t % pl.ktn) * w8s::KT;
    const CUtensorMap* map = slab < stack_slabs ? wa : wb;
    // a box wholly past the row is not loaded; its columns are never stored
    const int boxes = NW - n0 > w8s::BOX ? 2 : 1;
    w8s::mbar_expect_tx(r.full(s), boxes * w8s::KT * w8s::BOX);
    for (int i = 0; i < boxes; ++i)
      w8s::tma_load_3d(r.stage(s) + i * w8s::KT * w8s::BOX, map, r.full(s),
                       n0 + i * w8s::BOX, k0, e);
  }
}

// The x producer: each unit's chunk, KT values of its expert's live slot
// rows in 16-row boxes (rows past C zero-filled; the chunk's other boxes
// are not loaded). x was written before the launch. A box lands 2 KB after
// the last: 1024-byte aligned, so the 128-byte swizzle is the 64-row box's.
static __device__ __forceinline__ void produce_slots(const w8s::Plan& pl, const CUtensorMap* map,
                                                     const long long* counts, int C,
                                                     const w8s::Ring<W8A16>& r) {
  if (static_cast<int>(blockIdx.x) >= pl.blocks) return;
  const int t1 = w8s::first_tile(pl, blockIdx.x + 1);
  uint32_t it = 0;
  int e_at = -1, boxes = 0;
  for (int t = w8s::first_tile(pl, blockIdx.x); t < t1; ++t, ++it) {
    const int s = it % G::STAGES, e = t / pl.ktn / pl.slabs;
    if (e != e_at) {
      e_at = e;
      boxes = (live_rows(counts, e, C) + BOX_ROWS - 1) / BOX_ROWS;
    }
    w8s::mbar_wait(r.empty(s), ((it / G::STAGES) & 1) ^ 1);
    if (boxes == 0) {
      w8s::mbar_arrive(r.full(s));
      continue;
    }
    w8s::mbar_expect_tx(r.full(s), boxes * BOX_BYTES);   // rows past C count whole
    for (int i = 0; i < boxes; ++i)
      w8s::tma_load_3d(r.xchunk(s) + i * BOX_BYTES, map, r.full(s), (t % pl.ktn) * w8s::KT,
                       i * BOX_ROWS, e);
  }
}

// Block 0's count, by one warp: the live m16 tiles of every expert and all
// of them, added to tiles[0] and tiles[1].
static __device__ __forceinline__ void count_tiles(const long long* counts, int E, int C,
                                                   unsigned long long* tiles) {
  const int lane = threadIdx.x & 31;
  unsigned long long live = 0;
  for (int e = lane; e < E; e += 32) live += (live_rows(counts, e, C) + BOX_ROWS - 1) / BOX_ROWS;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) live += __shfl_xor_sync(0xffffffffu, live, o);
  if (lane == 0) {
    atomicAdd(tiles, live);
    atomicAdd(tiles + 1, static_cast<unsigned long long>(E) * ((C + BOX_ROWS - 1) / BOX_ROWS));
  }
}

// Store a run's partial j of expert e: the lane's columns col..col+7 of
// slot rows g and g + 8 of each m16 tile below its n live rows, at ws[j,
// e * C + row, col] (rows E * C, N columns). NW % 16 == 0, so a lane's 8
// columns are in or out.
static __device__ __forceinline__ void store_rows(float* ws, const float (&acc)[4][4][4], int j,
                                                  int rows, int N, int C, int e, int col,
                                                  int n) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (r < n) {
        float4* dst = reinterpret_cast<float4*>(ws + ((size_t)j * rows + e * C + r) * N + col);
        dst[0] = make_float4(acc[mt][0][2 * h], acc[mt][1][2 * h], acc[mt][2][2 * h],
                             acc[mt][3][2 * h]);
        dst[1] = make_float4(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1],
                             acc[mt][2][2 * h + 1], acc[mt][3][2 * h + 1]);
      }
    }
  }
}

// The stream: f32 partials ws (most, E * C, stacks * NW) of x (E, C, K) @
// the stacks' (E, K, NW) int8 weights, stack by stack along the columns,
// for each expert's live rows (counts (E,)); block 0 adds to `tiles`.
__global__ void __launch_bounds__(w8s::THREADS, 1)
moe_expert_stream_kernel(const w8s::Plan pl, const __grid_constant__ CUtensorMap wa,
                         const __grid_constant__ CUtensorMap wb,
                         const __grid_constant__ CUtensorMap xmap, float* __restrict__ ws,
                         const long long* __restrict__ counts,
                         unsigned long long* __restrict__ tiles, int E, int C, int NW,
                         int stacks) {
  extern __shared__ unsigned char dsmem[];
  const w8s::Ring<W8A16> ring{(w8s::smem_u32(dsmem) + 1023) & ~1023u};
  const int stack_slabs = pl.slabs / stacks;
  if (w8s::thread0()) w8s::ring_init(ring);
  __syncthreads();
  if (threadIdx.x >= w8s::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(w8s::PRODUCER_REGS));
    if (threadIdx.x == w8s::CONSUMERS) {
      produce_weights(pl, &wa, &wb, NW, stack_slabs, ring);
    } else if (threadIdx.x == w8s::CONSUMERS + 32) {
      produce_slots(pl, &xmap, counts, C, ring);
    } else if (blockIdx.x == 0 && tiles != nullptr &&
               threadIdx.x / 32 == w8s::CONSUMERS / 32 + 2) {
      count_tiles(counts, E, C, tiles);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(w8s::CONSUMER_REGS));
  const int warp = threadIdx.x >> 5, tq = threadIdx.x & 3;
  const w8s::Words8 wl;
  uint32_t it = 0;
  w8s::for_each_run(pl, [&](int t, int end, int m0, int slab, int j) {
    const int e = m0 / w8s::MT, n = live_rows(counts, e, C);
    float acc[4][4][4];
    w8s::zero(acc);
    with_slot_tiles(n, [&](auto mt_n) {
      for (; t < end; ++t, ++it)
        w8s::take_stage(ring, it, [&](uint32_t w, uint32_t xb) {
          if constexpr (decltype(mt_n)::value > 0)
            w8s::mma_stage_w8<decltype(mt_n)::value>(acc, wl, w, xb);
        });
    });
    const int col = (slab % stack_slabs) * G::SLAB + warp * 32 + 8 * tq;
    if (col < NW)
      store_rows(ws, acc, j, E * C, stacks * NW, C, e, (slab / stack_slabs) * NW + col, n);
  });
}

// The sum of one column quad's partials of stack `stack`, in index order.
static __device__ __forceinline__ float4 sum_partials(const float* __restrict__ ws,
                                                      const w8s::Plan& pl, size_t plane, int row,
                                                      int N, int e, int stack_slabs, int stack,
                                                      int NW, int n) {
  const int u = e * pl.slabs + stack * stack_slabs + n / G::SLAB;
  const int cnt = w8s::owner(pl, (u + 1) * pl.ktn - 1) - w8s::owner(pl, u * pl.ktn) + 1;
  const float* p = ws + (size_t)row * N + stack * NW + n;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < cnt; ++j) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + j * plane));
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  return acc;
}

static __device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// out[row, n..n+3] (E * C rows of NW) of a live row: one stack, bf16(sum *
// sa[e, n]); two (gate/up), bf16(silu(sum_a * sa[e, n]) * (sum_b * sb[e,
// n])), in f32. A dead row: +0 after one stack, left unwritten after two.
// A thread a (row, quad) of the whole grid, dead rows included: a
// grid-stride walk over 8-row groups with the counts in shared memory took
// ~10% less at DeepSeek-V2-Lite's decode shape and no less at Mixtral-
// 8x7B's, so the dead rows are not where a launch's time goes.
__global__ void moe_expert_finalize_kernel(const float* __restrict__ ws,
                                           const float* __restrict__ sa,
                                           const float* __restrict__ sb,
                                           const long long* __restrict__ counts,
                                           __nv_bfloat16* __restrict__ out, const w8s::Plan pl,
                                           int E, int C, int NW, int stacks) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = NW / 4;
  if (i >= (size_t)E * C * q) return;
  const int row = static_cast<int>(i / q), n = static_cast<int>(i % q) * 4;
  const int e = row / C, N = stacks * NW, stack_slabs = pl.slabs / stacks;
  if (row - e * C >= live_rows(counts, e, C)) {
    if (stacks == 1) *reinterpret_cast<uint2*>(out + (size_t)row * NW + n) = make_uint2(0u, 0u);
    return;
  }
  const size_t plane = (size_t)E * C * N;
  const float4 a = sum_partials(ws, pl, plane, row, N, e, stack_slabs, 0, NW, n);
  const float4 s = __ldg(reinterpret_cast<const float4*>(sa + (size_t)e * NW + n));
  float v[4] = {a.x * s.x, a.y * s.y, a.z * s.z, a.w * s.w};
  if (stacks == 2) {
    const float4 b = sum_partials(ws, pl, plane, row, N, e, stack_slabs, 1, NW, n);
    const float4 t = __ldg(reinterpret_cast<const float4*>(sb + (size_t)e * NW + n));
    const float h3[4] = {b.x * t.x, b.y * t.y, b.z * t.z, b.w * t.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = silu(v[c]) * h3[c];
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out + (size_t)row * NW + n) = u;
}

// x (E, C, K) bf16, C <= 64, K % 8 == 0, 16-byte aligned: boxes of KT
// values x 16 slot rows of one expert, 128-byte swizzled, zero-filled past
// C and K (w8s::encode_x's layout, with the expert as a third dimension).
static bool encode_slots(CUtensorMap* map, const void* x, int E, int C, int K) {
  w8s::EncodeTiled fn = w8s::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(K) * 2,
                                 static_cast<cuuint64_t>(C) * K * 2};
  const cuuint32_t box[3] = {w8s::KT, BOX_ROWS, 1};
  const cuuint32_t estrides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
            estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// One grouped launch: x (E, C, K) bf16 against `stacks` (1 or 2) int8
// stacks wa, wb (E, K, NW) with f32 scales sa, sb (E, NW) (wb, sb unused
// when stacks is 1), into out (E, C, NW) bf16 as above, for the live rows
// of counts (E,) int64 (expert e's rows 0..min(counts[e], C)-1); ws the f32
// partials (most, E * C, stacks * NW) of the plan {most, tiles, blocks,
// ktn, slabs} (kernels/w8a16_stream.plan over E * 64 rows and stacks *
// slabs slabs); `tile_count` two uint64 words block 0 adds the live and all
// m16 tiles to (null: none). C <= 64, K % 8 == 0, NW % 16 == 0, every base
// 16-byte aligned. Returns cudaGetLastError() after each launch.
extern "C" int pli_moe_expert_stream(const void* x, const void* wa, const void* sa,
                                     const void* wb, const void* sb, void* out, void* ws,
                                     const void* counts, void* tile_count, int E, int C, int K,
                                     int NW, int stacks, int most, int tiles, int blocks,
                                     int ktn, int slabs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const w8s::Plan pl{tiles, blocks, ktn, slabs, most};
  CUtensorMap amap, bmap, xmap;
  if (!w8s::encode_weights(&amap, wa, E, K, NW) || !w8s::encode_weights(&bmap, wb, E, K, NW) ||
      !encode_slots(&xmap, x, E, C, K))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(moe_expert_stream_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(STREAM_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part = static_cast<float*>(ws);
  const long long* live = static_cast<const long long*>(counts);
  moe_expert_stream_kernel<<<pl.blocks, w8s::THREADS, STREAM_SMEM, st>>>(
      pl, amap, bmap, xmap, part, live, static_cast<unsigned long long*>(tile_count), E, C, NW,
      stacks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t quads = (size_t)E * C * NW / 4;
  moe_expert_finalize_kernel<<<static_cast<unsigned>((quads + 255) / 256), 256, 0, st>>>(
      part, static_cast<const float*>(sa), static_cast<const float*>(sb), live,
      static_cast<__nv_bfloat16*>(out), pl, E, C, NW, stacks);
  return static_cast<int>(cudaGetLastError());
}
