// The streaming W8A16 GEMM phases of the fused decode kernel (K4 W8A16, K8):
// ws[j, m, n] = a partial sum over k of x[m, k] * w[l, k, n] for x (M, K)
// bf16 and w (L, K, N) int8, unscaled.
//
// Bound on the H100: the int8 weight bytes (at M = 64 each feeds 128
// operations, far below the ~295 flop/byte bf16 ridge), 177 MB a layer at the
// 7B widths. The design keeps enough of them in flight, across the grid
// barriers of the fused kernel too, and touches each of them once:
//  - The plan. Each GEMM phase is a flat list of (m-block, slab, k-tile)
//    units: 64 rows, SLAB = 256 columns, KT = 64 rows of K. Block b of G
//    takes units [b*T/G, (b+1)*T/G) (stream-K), so shares differ by at most
//    one k-tile and no phase runs a second partial wave. A block's run of
//    k-tiles within one slab is one partial, written to ws[j] with j = b
//    minus the first block of that slab; the consuming phase sums j = 0,
//    1, ... in order (`partials`), so the step stays deterministic. The
//    plan depends only on shapes and the grid: kernels/fused_decode.py
//    `_plan` computes the same ranges, sizes the workspace for its most
//    partials of a column and passes that bound in; a block whose partial
//    index reaches it (the two copies of the split apart) traps.
//  - The stream. A producer thread (in a warpgroup of its own) walks the
//    block's units of every GEMM phase of every layer and issues each weight
//    tile (KT x SLAB int8, two 128-column boxes of a 3-D tensor map over
//    (L, K, N), 128-byte swizzled, zero-filled past K and N) with TMA into a
//    ring of STAGES stages, each with a full and an empty mbarrier. It waits
//    only for a free stage, never on a grid barrier: weights do not depend
//    on activations, so the next phase's and the next layer's first tiles
//    land while the row, RoPE and attention phases run. Weights stay in
//    their (L, K, N) layout; no copy is made.
//  - Activations. A second producer thread puts the unit's x chunk (64 rows x
//    KT, bf16, 128-byte swizzled, zero-filled past M and K) into the same
//    stage with TMA, once a phase's activations exist: the consumers open
//    each GEMM phase after its grid barrier (`open_phase`), and the x
//    producer fences the async proxy before it reads what other blocks
//    wrote. A chunk feeds all 256 columns: 0.5 activation bytes a weight
//    byte. The consumers do no copies and meet at no barrier inside a
//    phase: loading x themselves (cp.async) with a consumer barrier a stage
//    held the stream well below what the same loop ran at without them.
//  - The math. Eight consumer warps, each all 64 rows x 32 columns of the
//    slab: mma.sync m16n8k16 (bf16, f32 accumulators in registers). A lane
//    reads four 32-bit words of its stage (rows 2t, 2t+1, 2t+8, 2t+9 of a
//    k16 step, columns 4g..4g+3; conflict-free under the swizzle) and
//    makes the B fragments of four n8 tiles from them in registers: each
//    byte is moved into an f32 2^23 + 128 + q with prmt, the bias is
//    subtracted (exact), and two upper halves are packed to bf16x2 with
//    prmt; n8 tile j holds columns 4g + j, so a lane ends with columns
//    8t..8t+7 of rows g and g + 8 and writes them as two float4. A-
//    fragments come from the x chunk with ldmatrix. The route is mma.sync;
//    wgmma was not built: this loop streams the gate/up phase at ~1.95
//    TB/s on an H100 SXM at 700 W (chip_smoke.py's phase clock), and what
//    the clock shows left is in the short phases and the barriers.
//  - Registers. The block is three warpgroups: the producers' gives its
//    registers up (setmaxnreg) and the two consumer warpgroups take them,
//    232 a thread, so the fused kernel's other phases do not spill.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_kv_attention.cuh"   // byte_f32

namespace w8s {

constexpr int KT = 64;                 // k rows a stage
constexpr int SLAB = 256;              // columns a unit
constexpr int BOX = 128;               // columns a TMA box: the 128-byte swizzle span
constexpr int MT = 64;                 // rows (requests) a unit
constexpr int STAGES = 5;              // 80 KB of weights in flight a block
constexpr int W_BYTES = KT * SLAB;     // a stage: the weight tile, then
constexpr int X_BYTES = MT * KT * 2;   // the x chunk (64 rows of 128 bytes)
constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
constexpr int CONSUMERS = 256;         // 8 consumer warps: warpgroups 0-1
constexpr int THREADS = CONSUMERS + 128; // + the producer's warpgroup
// Registers a thread after setmaxnreg: the consumers take what the producer
// gives up (2 x 128 x 232 + 128 x 40 <= 65,536).
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int BAR_CONSUMERS = 1;       // named barrier of the 256 consumers

// One GEMM phase's plan (kernels/fused_decode.py `_plan`).
struct Plan {
  int tiles;    // (m-block, slab, k-tile) units, m-block-major, k innermost
  int blocks;   // blocks that take part: min(grid, tiles)
  int ktn;      // k-tiles a slab
  int slabs;    // slabs an m-block
  int most;     // the most partials of a column: the workspace's bound
};

// The first unit of block b.
static __device__ __forceinline__ int first_tile(const Plan& pl, int b) {
  return static_cast<int>((long long)b * pl.tiles / pl.blocks);
}

// The block that takes unit t.
static __device__ __forceinline__ int owner(const Plan& pl, int t) {
  return static_cast<int>(((long long)(t + 1) * pl.blocks - 1) / pl.tiles);
}

// The partials of output (m, n): one from each block that took a part of
// its slab, j = 0, 1, ... in block order.
static __device__ __forceinline__ int partials(const Plan& pl, int m, int n) {
  const int u = (m / MT) * pl.slabs + n / SLAB;
  return owner(pl, (u + 1) * pl.ktn - 1) - owner(pl, u * pl.ktn) + 1;
}

// ---- shared memory, mbarriers, TMA -----------------------------------------

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// A wait that cannot end (a plan the producer and the consumers walk apart)
// faults after ten seconds instead of hanging the card; no wait of a
// working launch comes near it.
static __device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

static __device__ __forceinline__ void check_stuck(unsigned long long& since) {
  const unsigned long long now = global_ns();
  if (since == 0) since = now;
  else if (now - since > 10000000000ull) __trap();
}

// returns once the phase of parity `parity` has completed. The thread
// sleeps in try_wait until the phase completes (or the hint, 10 ms, runs
// out): a producer spinning in a loop took issue slots from the crews it
// shares a scheduler with.
static __device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  unsigned long long since = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity), "r"(10000000)
        : "memory");
    if (done) return;
    check_stuck(since);
  }
}

static __device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

static __device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The ring: STAGES stages (1024-byte aligned: the swizzle needs it), each a
// weight tile and an x chunk, then a full and an empty mbarrier a stage,
// then the count of GEMM phases the consumers have opened.
struct Ring {
  uint32_t base;
  __device__ __forceinline__ uint32_t stage(int s) const { return base + s * STAGE_BYTES; }
  __device__ __forceinline__ uint32_t xchunk(int s) const { return stage(s) + W_BYTES; }
  __device__ __forceinline__ uint32_t opened() const {
    return base + STAGES * STAGE_BYTES + 16 * STAGES;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + STAGES * STAGE_BYTES + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + STAGES * STAGE_BYTES + 8 * (STAGES + s);
  }
};
constexpr int RING_BYTES = STAGES * STAGE_BYTES + 16 * STAGES + 16;

// One thread: every stage's barriers (the full one counts the two
// producers' arrivals plus the TMA bytes, the empty one an arrive of each
// consumer warp), and no phase opened.
static __device__ __forceinline__ void ring_init(const Ring& r) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(r.full(s), 2);
    mbar_init(r.empty(s), CONSUMERS / 32);
  }
  asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(r.opened()) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer: issue this block's weight tiles of one GEMM phase of layer
// `layer`, `it` counting the tiles issued so far.
static __device__ __forceinline__ void produce(const Plan& pl, const CUtensorMap* map,
                                               int layer, int N, const Ring& r,
                                               uint32_t& it) {
  if (static_cast<int>(blockIdx.x) >= pl.blocks) return;
  const int t1 = first_tile(pl, blockIdx.x + 1);
  for (int t = first_tile(pl, blockIdx.x); t < t1; ++t, ++it) {
    const int s = it % STAGES;
    mbar_wait(r.empty(s), ((it / STAGES) & 1) ^ 1);   // round 0 passes
    const int n0 = ((t / pl.ktn) % pl.slabs) * SLAB, k0 = (t % pl.ktn) * KT;
    // a box wholly past N is not loaded; its columns are never stored
    const int boxes = N - n0 > BOX ? 2 : 1;
    mbar_expect_tx(r.full(s), boxes * KT * BOX);   // a box past K counts whole
    for (int i = 0; i < boxes; ++i)
      tma_load_3d(r.stage(s) + i * KT * BOX, map, r.full(s), n0 + i * BOX, k0, layer);
  }
}

// The x producer: wait until the consumers open GEMM phase number `phase`
// of the launch (its activations are written, by every block), then issue
// the x chunk of each of this block's units of it. Every phase is waited
// for, whether or not this block has units in it.
static __device__ __forceinline__ void produce_x(const Plan& pl, const CUtensorMap* map,
                                                 int phase, const Ring& r, uint32_t& it) {
  unsigned long long since = 0;
  for (;;) {
    uint32_t opened;
    asm volatile("ld.acquire.cta.shared.u32 %0, [%1];\n"
                 : "=r"(opened) : "r"(r.opened()) : "memory");
    if (static_cast<int>(opened) > phase) break;
    check_stuck(since);
    __nanosleep(256);   // a tight poll would take issue slots from a crew
  }
  // the activations came through generic stores; TMA reads by the async proxy
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  if (static_cast<int>(blockIdx.x) >= pl.blocks) return;
  const int t1 = first_tile(pl, blockIdx.x + 1);
  for (int t = first_tile(pl, blockIdx.x); t < t1; ++t, ++it) {
    const int s = it % STAGES;
    mbar_wait(r.empty(s), ((it / STAGES) & 1) ^ 1);
    mbar_expect_tx(r.full(s), X_BYTES);   // rows past M count whole
    tma_load_2d(r.xchunk(s), map, r.full(s), (t % pl.ktn) * KT,
                (t / pl.ktn / pl.slabs) * MT);
  }
}

// ---- the consumers ---------------------------------------------------------

// One consumer thread, after the grid barrier before GEMM phase `phase`:
// its activations are in; the x producer may read them.
static __device__ __forceinline__ void open_phase(const Ring& r, int phase) {
  if (threadIdx.x == 0)
    asm volatile("st.release.cta.shared.u32 [%0], %1;\n" ::"r"(r.opened()), "r"(phase + 1)
                 : "memory");
}

static __device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR_CONSUMERS), "n"(CONSUMERS) : "memory");
}

static __device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// bf16x2 of two small integers held exactly in f32: their upper halves.
static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

static __device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's share of one stage: four k16 steps of its warp's 32 columns
// against the first MT m16 tiles of the x chunk at xb. MT is a template
// parameter: a run-time row guard inside these unrolled loops kept the
// ldmatrix and mma from being scheduled together and halved the stream.
template <int MT_N>
static __device__ __forceinline__ void mma_stage(float (&acc)[4][4][4], uint32_t w0,
                                                 uint32_t wchunk, uint32_t xb, int lane) {
  const int tq = lane & 3;
  // ldmatrix: lane l gives row l % 16, 16-byte chunk l / 16 of an m16k16
  // tile; the chunk is swizzled by the row's low three bits
  const uint32_t xrow = xb + (lane & 15) * 128;
  const int xhi = lane >> 4, xsw = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    uint32_t wd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = kk * 16 + 2 * tq + (i & 1) + (i >> 1) * 8;
      wd[i] = lds32(w0 + row * BOX + ((wchunk ^ (row & 7)) << 4)) ^ 0x80808080u;
    }
    uint32_t bf[4][2];   // n8 tile j: columns 4 g + j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bf[j][0] = pack_bf16(kv_attn::byte_f32(wd[0], j), kv_attn::byte_f32(wd[1], j));
      bf[j][1] = pack_bf16(kv_attn::byte_f32(wd[2], j), kv_attn::byte_f32(wd[3], j));
    }
#pragma unroll
    for (int mt = 0; mt < MT_N; ++mt) {
      uint32_t a[4];
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                   : "r"(xrow + mt * 16 * 128 + (((2 * kk + xhi) ^ xsw) << 4)));
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a, bf[j][0], bf[j][1]);
    }
  }
}

// The consumers' walk of this block's units [t, end) of one slab, MT_N m16
// tiles of rows live: wait for a stage, compute, hand it back.
template <int MT_N>
static __device__ __forceinline__ void consume_run(float (&acc)[4][4][4], const Ring& r,
                                                   int t, int end, uint32_t& it) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  // the lane's weight words: box warp / 4, 16-byte chunk 2 (warp % 4) + g / 4
  // of a 128-byte row, word g % 4; rows 2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9 of
  // each k16 step, all with (row % 8) = 2 tq (+ 1)
  const uint32_t wbox = (warp >> 2) * KT * BOX + (g & 3) * 4;
  const uint32_t wchunk = 2 * (warp & 3) + (g >> 2);
  for (; t < end; ++t, ++it) {
    const int s = it % STAGES;
    mbar_wait(r.full(s), (it / STAGES) & 1);
    mma_stage<MT_N>(acc, r.stage(s) + wbox, wchunk, r.xchunk(s), lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty(s));
  }
}

// One GEMM phase on the consumers (threadIdx.x < CONSUMERS): this block's
// units of `pl` (M rows, N columns) against the stages the producers fill,
// the partials into ws (P, M, N). `it` counts the ring's stages consumed so
// far. A warp past N computes on stale bytes and stores nothing.
static __device__ void consume(const Plan& pl, float* ws, int M, int N, const Ring& r,
                               uint32_t& it) {
  const int b = blockIdx.x;
  if (b >= pl.blocks) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = first_tile(pl, b), t1 = first_tile(pl, b + 1);
  float acc[4][4][4];
  for (int t = t0; t < t1;) {
    // a run: this block's units of one slab, one partial
    const int u = t / pl.ktn, end = min(t1, (u + 1) * pl.ktn);
    const int m0 = (u / pl.slabs) * MT, n0 = (u % pl.slabs) * SLAB;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    switch (min(4, (M - m0 + 15) / 16)) {
      case 1: consume_run<1>(acc, r, t, end, it); break;
      case 2: consume_run<2>(acc, r, t, end, it); break;
      case 3: consume_run<3>(acc, r, t, end, it); break;
      default: consume_run<4>(acc, r, t, end, it); break;
    }
    t = end;
    // the run's partial j; N % 16 == 0, so a lane's 8 columns are in or out
    const int j = b - owner(pl, u * pl.ktn);
    if (j >= pl.most) __trap();   // past the workspace: the plans disagree
    const int col = n0 + warp * 32 + 8 * tq;
    if (col < N) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mt * 16 + g + 8 * h;
          if (m < M) {
            float4* dst = reinterpret_cast<float4*>(ws + ((size_t)j * M + m) * N + col);
            dst[0] = make_float4(acc[mt][0][2 * h], acc[mt][1][2 * h], acc[mt][2][2 * h],
                                 acc[mt][3][2 * h]);
            dst[1] = make_float4(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1],
                                 acc[mt][2][2 * h + 1], acc[mt][3][2 * h + 1]);
          }
        }
      }
    }
  }
}

// ---- host: the tensor maps -------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, fetched through the runtime so the
// library links no -lcuda
static EncodeTiled encode_tiled() {
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

// w (L, K, N) int8, N % 16 == 0, 16-byte aligned: boxes of KT rows x BOX
// columns of one layer, 128-byte swizzled, zero-filled past K and N.
static bool encode_weights(CUtensorMap* map, const void* w, int L, int K, int N) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(L)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N),
                                 static_cast<cuuint64_t>(K) * N};
  const cuuint32_t box[3] = {BOX, KT, 1};
  const cuuint32_t estrides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w), dims, strides, box,
            estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x (M, K) bf16, K % 8 == 0, 16-byte aligned: chunks of MT rows x KT
// columns (128 bytes), 128-byte swizzled, zero-filled past M and K.
static bool encode_x(CUtensorMap* map, const void* x, int M, int K) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {KT, MT};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides,
            box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace w8s
