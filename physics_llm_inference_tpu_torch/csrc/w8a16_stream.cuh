// The streaming GEMM phases of the fused decode kernel (K4 in its three
// modes, K8), and in W8A16 the decode-sized route of K1 (int8_matmul.cu)
// and K3's head (lmhead.cu): ws[j, m, n] = a partial sum over k of x[m, k]
// * w[l, k, n].
//  - W8A16 (K4's default, K8): x (M, K) bf16, w (L, K, N) int8, f32
//    partials, unscaled;
//  - W4A16: x bf16, w the nibble-packed (L, K, N/2) bytes (models/quant:
//    byte j of a row holds column j in its low nibble and N/2 + j in its
//    high one, both two's complement), the (L, K/G, N) group scales applied
//    inside: f32 partials of sum over groups of s[g, n] * (x_g @ w_g);
//  - W8A8: x the (M, K) int8 activation rows (row pitch a multiple of 16
//    bytes), w (L, K, N) int8, exact int32 partials.
//
// Bound on the H100: the weight bytes (at M = 64 each int8 byte feeds 128
// operations, each packed INT4 byte 256, far below the ~295 flop/byte bf16
// and ~590 op/byte int8 ridges), 177 MB a layer at the 7B widths (INT4: 89
// MB). The design keeps enough of them in flight, across the grid barriers
// of the fused kernel too, and touches each of them once:
//  - The plan. Each GEMM phase is a flat list of (m-block, slab, k-tile)
//    units: 64 rows, a slab of weight bytes (SLAB: 256 int8 columns, or 128
//    packed INT4 bytes, which are 256 output columns), KT = 64 rows of K.
//    Block b of G takes units [b*T/G, (b+1)*T/G) (stream-K), so shares
//    differ by at most one k-tile and no phase runs a second partial wave. A
//    block's run of k-tiles within one slab is one partial, written to ws[j]
//    with j = b minus the first block of that slab; the consuming phase sums
//    j = 0, 1, ... in order (`partials`), so the step stays deterministic.
//    The plan depends only on shapes and the grid: kernels/w8a16_stream.py
//    `plan` computes the same ranges, sizes the workspace for its most
//    partials of a column and passes that bound in; a block whose partial
//    index reaches it (the two copies of the split apart) traps.
//  - The stream. A producer thread (in a warpgroup of its own) walks the
//    block's units of every GEMM phase of every layer and issues each weight
//    tile (KT rows x SLAB bytes, 128-byte boxes of a 3-D tensor map over (L,
//    K, row bytes), 128-byte swizzled, zero-filled past K and N) with TMA into
//    a ring of stages, each with a full and an empty mbarrier. It waits only
//    for a free stage, never on a grid barrier: weights do not depend on
//    activations, so the next phase's and the next layer's first tiles land
//    while the row, RoPE and attention phases run. Weights stay in their
//    layout; no copy is made.
//  - Activations. A second producer thread puts the unit's x chunk (64 rows x
//    KT; bf16 128-byte swizzled, int8 64-byte swizzled; zero-filled past M
//    and K) into the same stage with TMA, once a phase's activations exist:
//    the consumers open each GEMM phase after its grid barrier
//    (`open_phase`), and the x producer fences the async proxy before it
//    reads what other blocks wrote. The consumers do no copies and meet at
//    no barrier inside a phase: loading x themselves (cp.async) with a
//    consumer barrier a stage held the stream well below what the same loop
//    ran at without them.
//  - The math. Eight consumer warps, each all 64 rows of its slice of the
//    slab, on mma.sync with the accumulators in registers; A-fragments come
//    from the x chunk with ldmatrix, B-fragments are made in registers from
//    32-bit words of the stage (conflict-free under the swizzle but for
//    W8A8's, which reads rows 8 apart):
//    W8A16: m16n8k16 bf16, 32 columns a warp; each byte becomes an f32
//      2^23 + 128 + q with prmt, the bias is subtracted (exact), and two
//      upper halves are packed to bf16x2;
//    W4A16: m16n8k16 bf16, 16 packed bytes (32 output columns) a warp; a
//      nibble pair of two k-rows is masked into the mantissa of bf16 128
//      with its sign bit flipped (offset binary; one lop3) and 136
//      subtracted in bf16x2 (exact). Each scale group is summed in f32 on
//      its own and added, times its scale row (TMA'd with the tile), to the
//      run's total at the group's end and at the run's end, in K order, as
//      the TPU kernel's `acc += (x_g @ q_g) * s_g`; the total waits in
//      shared memory. A warp's slice is half as wide: the group's sum has
//      the registers a W8A16 warp's accumulators have;
//    W8A8: m16n8k32 s8 with int32 accumulators, 32 columns a warp; four
//      k-rows' words are transposed (prmt) into four columns' k-quads.
//    In every mode n8 tile j holds columns 4g + j of the warp's slice (W4A16:
//    the packed bytes 2g + j % 2, nibble j / 2), so a lane ends with 8
//    neighbouring columns of rows g and g + 8 (W4A16: 4 low and 4 high).
//    The route is mma.sync; wgmma was not built: this loop streams W8A16's
//    gate/up phase at ~1.95 TB/s on an H100 SXM at 700 W (chip_smoke.py's
//    phase clock), and 8-bit wgmma takes only a K-major B, which the (K, N)
//    weights are not.
//  - Registers. The block is three warpgroups: the producers' gives its
//    registers up (setmaxnreg) and the two consumer warpgroups take them,
//    232 a thread, so the fused kernel's other phases do not spill.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "int8_kv_attention.cuh"   // byte_f32

namespace w8s {

// The K4 modes (kernels/fused_decode.py numbers them alike).
constexpr int W8A16 = 0, W4A16 = 1, W8A8 = 2;

constexpr int KT = 64;                 // k rows a stage
constexpr int BOX = 128;               // weight bytes of a row a TMA box: the swizzle span
constexpr int MT = 64;                 // rows (requests) a unit
constexpr int CONSUMERS = 256;         // 8 consumer warps: warpgroups 0-1
constexpr int THREADS = CONSUMERS + 128; // + the producer's warpgroup
// Registers a thread after setmaxnreg: the consumers take what the producer
// gives up (2 x 128 x 232 + 128 x 40 <= 65,536).
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int BAR_CONSUMERS = 1;       // named barrier of the 256 consumers
constexpr int RING_DATA = 5 * 24576;   // 120 KB of stages, every mode

// A mode's stage: the weight tile (KT rows x SLAB bytes), then the x chunk
// (MT rows x KT values), then (W4A16) the group scales of the tile's rows:
// up to SROWS rows of the slab's 128 low-half columns, then as many of its
// high-half columns; as many stages as RING_DATA holds (W8A16 5, W4A16 6,
// W8A8 6): 48-96 KB of weights in flight a block.
constexpr int SROWS = KT / 16;         // W4A16: groups a stage at most (G >= 16)
template <int kMode>
struct Geo {
  static constexpr int SLAB = kMode == W4A16 ? BOX : 2 * BOX;
  static constexpr int BOXES = SLAB / BOX;
  static constexpr int W_BYTES = KT * SLAB;
  static constexpr int X_BYTES = MT * KT * (kMode == W8A8 ? 1 : 2);
  static constexpr int S_HALF = SROWS * BOX * 4;   // a half's scale rows
  static constexpr int S_BYTES = kMode == W4A16 ? 2 * S_HALF : 0;
  static constexpr int STAGE_BYTES = W_BYTES + X_BYTES + S_BYTES;
  static constexpr int STAGES = RING_DATA / STAGE_BYTES;
  // the stages, a full and an empty mbarrier each, the opened count
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES + 16 * STAGES + 16;
};

// One GEMM phase's plan (kernels/w8a16_stream.py `plan`).
struct Plan {
  int tiles;    // (m-block, slab, k-tile) units, m-block-major, k innermost
  int blocks;   // blocks that take part: min(grid, tiles)
  int ktn;      // k-tiles a slab
  int slabs;    // slabs an m-block
  int most;     // the most partials of a column: the workspace's bound
};

// The first unit of block b (tiles * blocks < 2^32: `plan` checks it, so
// 32-bit unsigned arithmetic holds; a 64-bit division is a subroutine whose
// registers the GEMM loops' neighbours spilled for).
static __device__ __forceinline__ int first_tile(const Plan& pl, int b) {
  return static_cast<int>(static_cast<unsigned>(b) * pl.tiles / pl.blocks);
}

// The block that takes unit t.
static __device__ __forceinline__ int owner(const Plan& pl, int t) {
  return static_cast<int>((static_cast<unsigned>(t + 1) * pl.blocks - 1) / pl.tiles);
}

// threadIdx.x read anew at each use: what the compiler derives from it once
// for the whole launch (a predicate, a lane's addresses) stays live across
// every phase, and the GEMM loops, which take every register they may, made
// it spill.
static __device__ __forceinline__ int tid_x() {
  unsigned t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return static_cast<int>(t);
}

static __device__ __forceinline__ bool thread0() { return tid_x() == 0; }

// The partials of output (m, n) of an N-column phase: one from each block
// that took a part of its slab, j = 0, 1, ... in block order. W4A16: the
// slab of its packed byte, n mod N/2.
template <int kMode>
static __device__ __forceinline__ int partials(const Plan& pl, int m, int n, int N) {
  const int col = kMode == W4A16 ? n % (N / 2) : n;
  const int u = (m / MT) * pl.slabs + col / Geo<kMode>::SLAB;
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

// The ring of a mode: its stages (1024-byte aligned: the swizzle needs it),
// each a weight tile and an x chunk, then a full and an empty mbarrier a
// stage, then the count of GEMM phases the consumers have opened.
template <int kMode>
struct Ring {
  using G = Geo<kMode>;
  uint32_t base;
  __device__ __forceinline__ uint32_t stage(int s) const { return base + s * G::STAGE_BYTES; }
  __device__ __forceinline__ uint32_t xchunk(int s) const { return stage(s) + G::W_BYTES; }
  __device__ __forceinline__ uint32_t scales(int s) const { return xchunk(s) + G::X_BYTES; }
  __device__ __forceinline__ uint32_t opened() const {
    return base + G::STAGES * G::STAGE_BYTES + 16 * G::STAGES;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + G::STAGES * G::STAGE_BYTES + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + G::STAGES * G::STAGE_BYTES + 8 * (G::STAGES + s);
  }
};

// One thread: every stage's barriers (the full one counts the two
// producers' arrivals plus the TMA bytes, the empty one an arrive of each
// consumer warp), and no phase opened.
template <int kMode>
static __device__ __forceinline__ void ring_init(const Ring<kMode>& r) {
  for (int s = 0; s < Geo<kMode>::STAGES; ++s) {
    mbar_init(r.full(s), 2);
    mbar_init(r.empty(s), CONSUMERS / 32);
  }
  asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(r.opened()) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer: issue this block's weight tiles of one GEMM phase of layer
// `layer`, whose weight rows are NW bytes (W4A16: N/2), `it` counting the
// tiles issued so far. W4A16: with each tile, the rows of its groups (G
// rows a group; rows past K/G zero-filled) of the slab's columns of both
// halves from `smap`, the (L, K/G, N) scales.
template <int kMode>
static __device__ __forceinline__ void produce(const Plan& pl, const CUtensorMap* map,
                                               const CUtensorMap* smap, int layer, int NW,
                                               int G, const Ring<kMode>& r, uint32_t& it) {
  using G_ = Geo<kMode>;
  if (static_cast<int>(blockIdx.x) >= pl.blocks) return;
  const int t1 = first_tile(pl, blockIdx.x + 1);
  const int srows = kMode == W4A16 && G < KT ? KT / G : 1;
  for (int t = first_tile(pl, blockIdx.x); t < t1; ++t, ++it) {
    const int s = it % G_::STAGES;
    mbar_wait(r.empty(s), ((it / G_::STAGES) & 1) ^ 1);   // round 0 passes
    const int n0 = ((t / pl.ktn) % pl.slabs) * G_::SLAB, k0 = (t % pl.ktn) * KT;
    // a box wholly past the row is not loaded; its columns are never stored
    const int boxes = G_::BOXES == 2 && NW - n0 > BOX ? 2 : 1;
    // a box past K (or K/G) counts whole
    mbar_expect_tx(r.full(s), boxes * KT * BOX + (kMode == W4A16 ? 2 * srows * BOX * 4 : 0));
    for (int i = 0; i < boxes; ++i)
      tma_load_3d(r.stage(s) + i * KT * BOX, map, r.full(s), n0 + i * BOX, k0, layer);
    if constexpr (kMode == W4A16) {
      tma_load_3d(r.scales(s), smap, r.full(s), n0, k0 / G, layer);
      tma_load_3d(r.scales(s) + G_::S_HALF, smap, r.full(s), NW + n0, k0 / G, layer);
    }
  }
}

// The x producer: wait until the consumers open GEMM phase number `phase`
// of the launch (its activations are written, by every block), then issue
// the x chunk of each of this block's units of it. Every phase is waited
// for, whether or not this block has units in it.
template <int kMode>
static __device__ __forceinline__ void produce_x(const Plan& pl, const CUtensorMap* map,
                                                 int phase, const Ring<kMode>& r,
                                                 uint32_t& it) {
  using G = Geo<kMode>;
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
    const int s = it % G::STAGES;
    mbar_wait(r.empty(s), ((it / G::STAGES) & 1) ^ 1);
    mbar_expect_tx(r.full(s), G::X_BYTES);   // rows past M count whole
    tma_load_2d(r.xchunk(s), map, r.full(s), (t % pl.ktn) * KT,
                (t / pl.ktn / pl.slabs) * MT);
  }
}

// ---- the consumers ---------------------------------------------------------

// One consumer thread, after the grid barrier before GEMM phase `phase`:
// its activations are in; the x producer may read them.
template <int kMode>
static __device__ __forceinline__ void open_phase(const Ring<kMode>& r, int phase) {
  if (thread0())
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

// ldmatrix x4: the A fragment of one m16 tile and 32-byte k step (bf16 k16,
// int8 k32); lane l gives the address of row l % 16, 16-byte chunk l / 16
static __device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
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

static __device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Walk this block's share of `pl` run by run: run(t, end, m0, slab, j) for
// its units [t, end) of one slab, rows from m0, its partial j.
template <class Run>
static __device__ __forceinline__ void for_each_run(const Plan& pl, Run run) {
  const int b = blockIdx.x;
  if (b >= pl.blocks) return;
  const int t1 = first_tile(pl, b + 1);
  for (int t = first_tile(pl, b); t < t1;) {
    const int u = t / pl.ktn, end = min(t1, (u + 1) * pl.ktn);
    const int j = b - owner(pl, u * pl.ktn);
    if (j >= pl.most) __trap();   // past the workspace: the plans disagree
    run(t, end, (u / pl.slabs) * MT, u % pl.slabs, j);
    t = end;
  }
}

// Wait for stage `it`, run the lane's share of it, hand it back.
template <int kMode, class Stage>
static __device__ __forceinline__ void take_stage(const Ring<kMode>& r, uint32_t it,
                                                  Stage stage) {
  const int s = it % Geo<kMode>::STAGES;
  mbar_wait(r.full(s), (it / Geo<kMode>::STAGES) & 1);
  stage(r.stage(s), r.xchunk(s));
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty(s));
}

// The m16 tiles live in a run of M rows from m0, as a template parameter: a
// run-time row guard inside the unrolled ldmatrix/mma loops kept them from
// being scheduled together and halved the stream.
template <class Body>
static __device__ __forceinline__ void with_live_tiles(int rows, Body body) {
  switch (min(4, (rows + 15) / 16)) {
    case 1: body(std::integral_constant<int, 1>()); break;
    case 2: body(std::integral_constant<int, 2>()); break;
    case 3: body(std::integral_constant<int, 3>()); break;
    default: body(std::integral_constant<int, 4>()); break;
  }
}

template <class T>
static __device__ __forceinline__ void zero(T (&acc)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// Store a run's 8-bit-mode partial j: the lane's columns col..col+7 (n8
// tile j' holds col + j' and col + 4 + j') of rows g and g + 8 of each m16
// tile. N % 16 == 0, so a lane's 8 columns are in or out.
template <class T, class T4>
static __device__ __forceinline__ void store8(T* ws, const T (&acc)[4][4][4], int j, int M,
                                              int N, int m0, int col) {
  const int g = (threadIdx.x & 31) >> 2;
  if (col >= N) return;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mt * 16 + g + 8 * h;
      if (m < M) {
        T4* dst = reinterpret_cast<T4*>(ws + ((size_t)j * M + m) * N + col);
        dst[0] = T4{acc[mt][0][2 * h], acc[mt][1][2 * h], acc[mt][2][2 * h], acc[mt][3][2 * h]};
        dst[1] = T4{acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1], acc[mt][2][2 * h + 1],
                    acc[mt][3][2 * h + 1]};
      }
    }
  }
}

// The lane's weight words in an 8-bit mode: box warp / 4, 16-byte chunk
// 2 (warp % 4) + g / 4 of a 128-byte row, word g % 4 (columns 4 g..4 g + 3
// of the warp's 32); a row's chunk is swizzled by its low three bits.
struct Words8 {
  uint32_t box;   // byte offset of the lane's word in a row's box
  uint32_t chunk; // its chunk before the swizzle
  __device__ __forceinline__ Words8() {
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
    box = (warp >> 2) * KT * BOX + (g & 3) * 4;
    chunk = 2 * (warp & 3) + (g >> 2);
  }
  __device__ __forceinline__ uint32_t at(uint32_t w, int row) const {
    return lds32(w + box + row * BOX + ((chunk ^ (row & 7)) << 4));
  }
};

// ---- W8A16 -----------------------------------------------------------------

// The lane's share of one stage: four k16 steps of its warp's 32 columns
// against the first MT_N m16 tiles of the x chunk at xb. A lane reads rows
// 2t, 2t+1, 2t+8, 2t+9 of each k16 step (all (row % 8) distinct).
template <int MT_N>
static __device__ __forceinline__ void mma_stage_w8(float (&acc)[4][4][4], const Words8& wl,
                                                    uint32_t w, uint32_t xb) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
  const uint32_t xrow = xb + (lane & 15) * 128;   // 128-byte rows, 128-byte swizzle
  const int xhi = lane >> 4, xsw = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    uint32_t wd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wd[i] = wl.at(w, kk * 16 + 2 * tq + (i & 1) + (i >> 1) * 8) ^ 0x80808080u;
    uint32_t bf[4][2];   // n8 tile j: columns 4 g + j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bf[j][0] = pack_bf16(kv_attn::byte_f32(wd[0], j), kv_attn::byte_f32(wd[1], j));
      bf[j][1] = pack_bf16(kv_attn::byte_f32(wd[2], j), kv_attn::byte_f32(wd[3], j));
    }
#pragma unroll
    for (int mt = 0; mt < MT_N; ++mt) {
      uint32_t a[4];
      ldsm_x4(a, xrow + mt * 16 * 128 + (((2 * kk + xhi) ^ xsw) << 4));
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a, bf[j][0], bf[j][1]);
    }
  }
}

// W8A16: this block's units of `pl` (M rows, N columns) into the f32
// partials ws (P, M, N). A warp past N computes on stale bytes and stores
// nothing.
static __device__ void consume_w8(const Plan& pl, float* ws, int M, int N,
                                  const Ring<W8A16>& r, uint32_t& it) {
  const int warp = threadIdx.x >> 5, tq = threadIdx.x & 3;
  const Words8 wl;
  for_each_run(pl, [&](int t, int end, int m0, int slab, int j) {
    float acc[4][4][4];
    zero(acc);
    with_live_tiles(M - m0, [&](auto mt_n) {
      for (; t < end; ++t, ++it)
        take_stage(r, it, [&](uint32_t w, uint32_t xb) {
          mma_stage_w8<decltype(mt_n)::value>(acc, wl, w, xb);
        });
    });
    store8<float, float4>(ws, acc, j, M, N, m0, slab * Geo<W8A16>::SLAB + warp * 32 + 8 * tq);
  });
}

// ---- W8A8 ------------------------------------------------------------------

// Columns of four k-rows' words: out[j] holds byte j of in[0..3], k order.
static __device__ __forceinline__ void transpose4(uint32_t (&out)[4], const uint32_t* in) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140), t1 = __byte_perm(in[0], in[1], 0x7362);
  const uint32_t t2 = __byte_perm(in[2], in[3], 0x5140), t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// The lane's share of one stage: two k32 steps of its warp's 32 columns
// against the first MT_N m16 tiles of the int8 x chunk (64-byte rows,
// 64-byte swizzle: chunk c of row R at c ^ (R / 2 % 4)). A lane reads rows
// 4t..4t+3 and 16+4t..16+4t+3 of each k32 step; rows 8 apart share a bank
// (a 2-way conflict the layout leaves).
template <int MT_N>
static __device__ __forceinline__ void mma_stage_a8(int (&acc)[4][4][4], const Words8& wl,
                                                    uint32_t w, uint32_t xb) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
  const uint32_t xrow = xb + (lane & 15) * 64;
  const int xhi = lane >> 4, xsw = ((lane & 15) >> 1) & 3;
#pragma unroll
  for (int kk = 0; kk < KT / 32; ++kk) {
    uint32_t wd[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) wd[i] = wl.at(w, kk * 32 + (i >> 2) * 16 + 4 * tq + (i & 3));
    uint32_t b0[4], b1[4];   // n8 tile j: columns 4 g + j
    transpose4(b0, wd);
    transpose4(b1, wd + 4);
#pragma unroll
    for (int mt = 0; mt < MT_N; ++mt) {
      uint32_t a[4];
      ldsm_x4(a, xrow + mt * 16 * 64 + (((2 * kk + xhi) ^ xsw) << 4));
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[mt][j], a, b0[j], b1[j]);
    }
  }
}

// W8A8: this block's units of `pl` into the exact int32 partials ws.
static __device__ void consume_a8(const Plan& pl, int* ws, int M, int N,
                                  const Ring<W8A8>& r, uint32_t& it) {
  const int warp = threadIdx.x >> 5, tq = threadIdx.x & 3;
  const Words8 wl;
  for_each_run(pl, [&](int t, int end, int m0, int slab, int j) {
    int acc[4][4][4];
    zero(acc);
    with_live_tiles(M - m0, [&](auto mt_n) {
      for (; t < end; ++t, ++it)
        take_stage(r, it, [&](uint32_t w, uint32_t xb) {
          mma_stage_a8<decltype(mt_n)::value>(acc, wl, w, xb);
        });
    });
    store8<int, int4>(ws, acc, j, M, N, m0, slab * Geo<W8A8>::SLAB + warp * 32 + 8 * tq);
  });
}

// ---- W4A16 -----------------------------------------------------------------

// bf16x2 of the two nibbles at bits 0-3 and 16-19 of x (two's complement):
// (x & 0x000F000F) ^ 0x43084308 puts each, offset by 8, in the mantissa of
// bf16 128; 136 subtracted leaves it, exactly.
static __device__ __forceinline__ uint32_t nibbles_bf16(uint32_t x) {
  const uint32_t y = (x & 0x000F000Fu) ^ 0x43084308u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(y), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

static __device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

static __device__ __forceinline__ void sts128(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// W4A16 keeps a run's total in shared memory, not in registers beside the
// group's sum: both sets (128 registers) left the rest of the kernel too few
// and it spilled. A warp's total is TOT_WARP bytes, its lane's float4 of
// n8 tile j of m16 tile mt at ((4 mt + j) * 32 + lane) * 16.
constexpr int TOT_WARP = 16 * 32 * 16;

// tot += grp * s, grp = 0, for s the scale row at `row` in the stage (the
// lane's columns col..col+3 there, and S_HALF on those of the high half)
// and tot the lane's total at `tot`. The product is rounded, then the sum,
// as the TPU kernel's `acc += part * s`.
template <int MT_N>
static __device__ __forceinline__ void flush_group(float (&grp)[4][4][4], uint32_t row,
                                                   uint32_t tot) {
  const float4 l = lds128(row), h = lds128(row + Geo<W4A16>::S_HALF);
  const float lo[4] = {l.x, l.y, l.z, l.w}, hi[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
  for (int mt = 0; mt < MT_N; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t at = tot + (4 * mt + j) * 32 * 16;
      const float4 t = lds128(at);
      float v[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sc = j < 2 ? lo[2 * (e & 1) + (j & 1)] : hi[2 * (e & 1) + (j & 1)];
        v[e] = __fadd_rn(v[e], __fmul_rn(grp[mt][j][e], sc));
        grp[mt][j][e] = 0.f;
      }
      sts128(at, make_float4(v[0], v[1], v[2], v[3]));
    }
}

// The lane's share of one stage: four k16 steps of its warp's 16 packed
// bytes (chunk `warp` of the 128-byte box) against the first MT_N m16
// tiles of the x chunk. A lane reads the word holding packed bytes 2g, 2g+1
// of rows 2t, 2t+1, 2t+8, 2t+9 and keeps their half (`sel`). GS = G / 16
// when a group is shorter than a stage (each ends inside it and is flushed
// there, its scales at row kk / GS of `srow`, the lane's columns of the
// stage's first scale row); else 4, and `last` says whether a group or the
// run ends with this stage.
template <int MT_N, int GS>
static __device__ __forceinline__ void mma_stage_w4(float (&grp)[4][4][4], uint32_t w,
                                                    uint32_t xb, uint32_t srow, bool last,
                                                    int warp, int lane, uint32_t tot) {
  const int tq = lane & 3, g = lane >> 2;
  const uint32_t sel = g & 1 ? 0x7632u : 0x5410u;
  const uint32_t wq = w + 4 * (g >> 1);
  const uint32_t c0 = (warp ^ (2 * tq)) << 4, c1 = (warp ^ (2 * tq + 1)) << 4;
  const uint32_t xrow = xb + (lane & 15) * 128;
  const int xhi = lane >> 4, xsw = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    const uint32_t r0 = wq + (kk * 16 + 2 * tq) * BOX;
    const uint32_t u01 = __byte_perm(lds32(r0 + c0), lds32(r0 + BOX + c1), sel);
    const uint32_t u89 = __byte_perm(lds32(r0 + 8 * BOX + c0), lds32(r0 + 9 * BOX + c1), sel);
    // n8 tile j: packed byte 2 g + j % 2, low nibble (j < 2) or high
    uint32_t bf[4][2];
    bf[0][0] = nibbles_bf16(u01);
    bf[1][0] = nibbles_bf16(u01 >> 8);
    bf[2][0] = nibbles_bf16(u01 >> 4);
    bf[3][0] = nibbles_bf16(u01 >> 12);
    bf[0][1] = nibbles_bf16(u89);
    bf[1][1] = nibbles_bf16(u89 >> 8);
    bf[2][1] = nibbles_bf16(u89 >> 4);
    bf[3][1] = nibbles_bf16(u89 >> 12);
#pragma unroll
    for (int mt = 0; mt < MT_N; ++mt) {
      uint32_t a[4];
      ldsm_x4(a, xrow + mt * 16 * 128 + (((2 * kk + xhi) ^ xsw) << 4));
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(grp[mt][j], a, bf[j][0], bf[j][1]);
    }
    if constexpr (GS < 4) {
      if ((kk + 1) % GS == 0) flush_group<MT_N>(grp, srow + (kk / GS) * BOX * 4, tot);
    }
  }
  if constexpr (GS == 4) {
    if (last) flush_group<MT_N>(grp, srow, tot);
  }
}

// W4A16: this block's units of `pl` over the packed (K, N/2) bytes, with G
// rows a scale group (G % 16 == 0), into the f32 partials ws (P, M, N): a
// lane's packed columns col..col+3 give output columns col..col+3 and N/2 +
// col..N/2 + col+3 (N/2 % 16 == 0, so they are in or out). `scratch`: the
// consumer warps' totals, 8 TOT_WARP bytes of shared memory free during a
// GEMM phase.
static __device__ void consume_w4(const Plan& pl, float* ws, int M, int N, int G,
                                  uint32_t scratch, const Ring<W4A16>& r, uint32_t& it) {
  // the lane's constants made here, not once for the launch (tid_x)
  const int tid = tid_x(), warp = tid >> 5, lane = tid & 31, tq = lane & 3;
  const int NH = N / 2;
  const uint32_t scol = (16 * warp + 4 * tq) * 4;   // the lane's scale columns
  const uint32_t tot = scratch + warp * TOT_WARP + lane * 16;
  for_each_run(pl, [&](int t, int end, int m0, int slab, int j) {
    float grp[4][4][4];
    zero(grp);
#pragma unroll
    for (int q = 0; q < 16; ++q) sts128(tot + q * 32 * 16, make_float4(0.f, 0.f, 0.f, 0.f));
    with_live_tiles(M - m0, [&](auto mt_n) {
      constexpr int MT_N = decltype(mt_n)::value;
      auto run = [&](auto gsteps) {
        constexpr int GS = decltype(gsteps)::value;
        for (; t < end; ++t, ++it) {
          // a group of whole stages ends with this one, or the run does
          const bool last = ((t % pl.ktn) * KT + KT) % G == 0 || t + 1 == end;
          take_stage(r, it, [&](uint32_t w, uint32_t xb) {
            mma_stage_w4<MT_N, GS>(grp, w, xb,
                                   w + Geo<W4A16>::W_BYTES + Geo<W4A16>::X_BYTES + scol,
                                   last, warp, lane, tot);
          });
        }
      };
      if (G == 16) run(std::integral_constant<int, 1>());
      else if (G == 32) run(std::integral_constant<int, 2>());
      else run(std::integral_constant<int, 4>());
    });
    const int col = slab * Geo<W4A16>::SLAB + 16 * warp + 4 * tq;
    if (col >= NH) return;
    const int g = lane >> 2;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      float4 v[4];   // n8 tiles 0-3 (low, low, high, high) of rows g, g + 8
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) v[jj] = lds128(tot + (4 * mt + jj) * 32 * 16);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mt * 16 + g + 8 * h;
        if (m < M) {
          float* dst = ws + ((size_t)j * M + m) * N + col;
          *reinterpret_cast<float4*>(dst) =
              h ? make_float4(v[0].z, v[1].z, v[0].w, v[1].w)
                : make_float4(v[0].x, v[1].x, v[0].y, v[1].y);
          *reinterpret_cast<float4*>(dst + NH) =
              h ? make_float4(v[2].z, v[3].z, v[2].w, v[3].w)
                : make_float4(v[2].x, v[3].x, v[2].y, v[3].y);
        }
      }
    }
  });
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

// w (L, K, NW) bytes (int8, or packed INT4 with NW = N/2), NW % 16 == 0,
// 16-byte aligned: boxes of KT rows x BOX bytes of one layer, 128-byte
// swizzled, zero-filled past K and NW.
static bool encode_weights(CUtensorMap* map, const void* w, int L, int K, int NW) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(NW), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(L)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(NW),
                                 static_cast<cuuint64_t>(K) * NW};
  const cuuint32_t box[3] = {BOX, KT, 1};
  const cuuint32_t estrides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w), dims, strides, box,
            estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// s (L, K/G, N) f32 group scales, N % 4 == 0: boxes of BOX columns x
// `rows` groups of one layer, zero-filled past K/G and N.
static bool encode_scales(CUtensorMap* map, const float* s, int L, int groups, int N,
                          int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(groups),
                              static_cast<cuuint64_t>(L)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 4,
                                 static_cast<cuuint64_t>(groups) * N * 4};
  const cuuint32_t box[3] = {BOX, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estrides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(s), dims, strides,
            box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x (M, K) rows `pitch` bytes apart (a multiple of 16), 16-byte aligned:
// chunks of `rows` (a unit's MT, or K1's prefill route's 128) rows x KT
// values, zero-filled past M and K. bf16 (W8A16, W4A16): 128-byte rows,
// 128-byte swizzle; `bytes`, int8 (W8A8): 64-byte rows, 64-byte swizzle.
static bool encode_x(CUtensorMap* map, const void* x, int M, int K, int pitch, bool bytes,
                     int rows = MT) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {KT, static_cast<cuuint32_t>(rows)};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(map, bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(x), dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            bytes ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace w8s
