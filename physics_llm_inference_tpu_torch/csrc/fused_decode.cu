// K4 and K8: the whole INT8 W+KV decode step for all layers, in one launch.
//
// K4 replaces the TPU kernel physics_llm_inference_tpu/kernels/
// fused_decode.py (fused_decode_step -> _kernel) in its default configuration
// (K-blocked weight tiles, silu per DOWN tile, bf16 activations). K8 replaces
// fused_paged_decode_step -> _paged_kernel_r5 of the same file: the same
// kernel with a paged address mode in the attention phase only (the
// fused_decode_kernel<true> instance). Its KV lives in the merged INT8 block
// pools (L, NB, 2, BS, Hkv*d) / (L, NB, 2, Hkv, BS) f32 reached through the
// block table; request b attends its keys [0, lengths[b]) plus the current
// token and, in place, writes the new codes and scales at position
// lengths[b] of block tables[b, min(lengths[b] / BS, MB - 1)], after that
// item's own reads. Of the TPU kernel's machinery (request groups, rotating
// value rings, the layer-resident scale copy, DMA semaphores, 8-slot write
// windows) nothing is needed here: a pool row is addressed directly. Per layer: RMSNorm,
// QKV, RoPE, KV quantize and write, attention over the INT8 cache plus the
// current token, WO, RMSNorm, gate/up, silu * up, down. The numerics are the
// TPU kernel's: the residual stream stays f32 across all layers and is cast
// to bf16 once at the end; qkv, gate and up are rounded to bf16 after their
// f32 sums; K is rounded to bf16 after RoPE and quantized per head; the
// current token attends through the dequantized int8 values the cache will
// hold; p * v_scale is rounded to bf16 before P@V.
//
// Bound on the H100: int8 weight bytes (at B = 64 every weight byte feeds 128
// flop, far below the ~295 flop/byte ridge) plus the live KV bytes. The TPU
// kernel keeps activations in VMEM and walks one sequential grid; here one
// persistent cooperative launch covers the step (grid = SMs x resident
// blocks), and the phases of a layer are separated by grid-wide barriers.
// Each phase walks a flat list of work items with a grid-stride loop:
//   1. QKV partials: (m-tile, n-tile, k-split) items of the W8A16 tile
//      (w8a16_tile.cuh); K is split so that N = 6144 still fills the card;
//   2. per (request, kv head): fixed-order sum of the partials, bf16, RoPE,
//      quantize K/V into the new-KV buffers;
//   3. per (request, kv head): attention over the cache slots
//      [valid_from, q_slot) (kv_attn::attend, shared with K2; K8: the
//      request's pool blocks through the table), merged with the current
//      token, then the in-place cache write at `slot` (K8: the request's
//      own write position) after this item's own reads of that cache row;
//   4. WO partials;  5. per request: x += sum * scale, then RMSNorm -> h;
//   6. gate/up partials;  7. silu(gate) * up -> ff;
//   8. DOWN partials;  9. per request: x += sum * scale, then the next
//      layer's RMSNorm (or the bf16 output after the last layer).
// Partials go to an f32 workspace and are summed in a fixed order (no float
// atomics), so the step is deterministic. L1 is not coherent across SMs, so
// everything another block wrote in this launch is read with ld.global.cg.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_kv_attention.cuh"
#include "w8a16_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
static_assert(THREADS == w8a16::THREADS && THREADS == kv_attn::THREADS,
              "the phases share one block shape");
constexpr int NWARPS = THREADS / 32;
constexpr size_t SMEM_BYTES =
    sizeof(w8a16::Smem) > sizeof(kv_attn::Smem) ? sizeof(w8a16::Smem)
                                                : sizeof(kv_attn::Smem);

struct Params {
  const __nv_bfloat16* x0;                 // (B, D)
  const __nv_bfloat16* ln1;                // (L, D)
  const __nv_bfloat16* ln2;                // (L, D)
  const int8_t* wqkv; const float* sqkv;   // (L, D, QO), (L, QO)
  const int8_t* wo; const float* swo;      // (L, HQ*HD, D), (L, D)
  const int8_t* wgu; const float* sgu;     // (L, D, 2F), (L, 2F)
  const int8_t* wdn; const float* sdn;     // (L, F, D), (L, D)
  int8_t* kq; float* ks;                   // (L, B, S, HKV*HD), (L, B, HKV, S)
  int8_t* vq; float* vs;                   // K8: kq/ks are the merged pools
                                           // (L, NB, 2, BS, HKV*HD) and
                                           // (L, NB, 2, HKV, BS); vq/vs unused
  const int* tables;                       // K8: (B, MB) block table
  const float* cos; const float* sin;      // (B, HD/2)
  const int* q_slot; const int* valid_from;  // (B,); K8: q_slot = lengths
  int8_t* k_new; float* ks_new;            // (L, B, HKV*HD), (L, B, HKV)
  int8_t* v_new; float* vs_new;
  __nv_bfloat16* x_out;                    // (B, D)
  float* xf;                               // (B, D) f32 residual stream
  __nv_bfloat16* h;                        // (B, D) normed activations
  __nv_bfloat16* qbuf;                     // (B, HQ*HD) post-RoPE queries
  __nv_bfloat16* attn;                     // (B, HQ*HD)
  __nv_bfloat16* ff;                       // (B, F)
  float* ws;                               // (splits, B, N) f32 partials
  int L, B, S, D, F, HQ, HKV, HD;
  int NB, MB, BS;                          // K8: pool blocks, table width, block size
  int slot, write_cache;
  int split_qkv, split_wo, split_gu, split_dn;
  float eps, scale;
};

static __device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) t += red[w];
  __syncthreads();
  return t;
}

static __device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) t = fmaxf(t, red[w]);
  __syncthreads();
  return t;
}

static __device__ __forceinline__ float bf(float x) { return kv_attn::round_bf16(x); }

// Sum of the k-split partials of output (b, n), in split order.
static __device__ __forceinline__ float partial_sum(const float* ws, int splits,
                                                    int B, int N, int b, int n) {
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += __ldcg(ws + ((size_t)s * B + b) * N + n);
  return acc;
}

// ws[split, m, n] = sum over the split's K range of x[m, k] * w[k, n]
// (unscaled), for x (M, K) bf16 and w (K, N) int8.
static __device__ void gemm_partials(const __nv_bfloat16* x, const int8_t* w,
                                     float* ws, int M, int N, int K, int splits,
                                     w8a16::Smem& sm) {
  using namespace w8a16;
  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  const int per = ((K + BK - 1) / BK + splits - 1) / splits;  // k-tiles per split
  const int items = mt * nt * splits;
  const bool vec_x = K % 8 == 0, vec_w = N % 16 == 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int split = it % splits, tile = it / splits;
    const int n0 = (tile % nt) * BN, m0 = (tile / nt) * BM;
    const int k_begin = split * per * BK;
    const int k_end = min(K, k_begin + per * BK);
    tile_gemm(x, w, M, N, K, k_begin, k_end, m0, n0, vec_x, vec_w, sm);
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN, gm = m0 + r, gn = n0 + c;
      if (gm < M && gn < N) ws[((size_t)split * M + gm) * N + gn] = sm.c[r * CS_LD + c];
    }
    __syncthreads();
  }
}

// Per request b: x = x0 (init) or x += scale * partials; then h =
// bf16(rms(x) * ln) when ln is given, else x_out = bf16(x).
static __device__ void rows_phase(const Params& p, const float* scale, int splits,
                                  const __nv_bfloat16* ln, bool init, float* red) {
  const int D = p.D;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    float* xr = p.xf + (size_t)b * D;
    float ss = 0.f;
    for (int n = threadIdx.x; n < D; n += THREADS) {
      float x;
      if (init) {
        x = __bfloat162float(p.x0[(size_t)b * D + n]);
      } else {
        x = __ldcg(xr + n) + partial_sum(p.ws, splits, p.B, D, b, n) * scale[n];
      }
      xr[n] = x;
      ss += x * x;
    }
    if (ln != nullptr) {
      const float tot = block_sum(ss, red);
      const float r = 1.f / sqrtf(tot / D + p.eps);
      for (int n = threadIdx.x; n < D; n += THREADS) {
        p.h[(size_t)b * D + n] =
            __float2bfloat16(__ldcg(xr + n) * r * __bfloat162float(ln[n]));
      }
    } else {
      for (int n = threadIdx.x; n < D; n += THREADS)
        p.x_out[(size_t)b * D + n] = __float2bfloat16(__ldcg(xr + n));
    }
    __syncthreads();
  }
}

// Per (request, kv head): qkv = bf16(scale * partials); RoPE on the group's
// query heads -> qbuf (bf16); K rotated and rounded to bf16, V as is; both
// quantized per head (absmax / 127, round half to even, clip +-127) into the
// new-KV buffers of layer l.
static __device__ void qkv_phase(const Params& p, int l, float* red, float* kv_sm) {
  const int HD = p.HD, hd2 = HD / 2, group = p.HQ / p.HKV;
  const int QH = p.HQ * HD, KH = p.HKV * HD, QO = QH + 2 * KH;
  const float* sc = p.sqkv + (size_t)l * QO;
  float* kf = kv_sm;
  float* vf = kv_sm + HD;
  for (int it = blockIdx.x; it < p.B * p.HKV; it += gridDim.x) {
    const int b = it / p.HKV, g = it % p.HKV;
    const float* cs = p.cos + (size_t)b * hd2;
    const float* sn = p.sin + (size_t)b * hd2;
    auto val = [&](int n) {
      return bf(partial_sum(p.ws, p.split_qkv, p.B, QO, b, n) * sc[n]);
    };
    for (int i = threadIdx.x; i < group * hd2; i += THREADS) {
      const int col = (g * group + i / hd2) * HD + i % hd2;
      const float x1 = val(col), x2 = val(col + hd2);
      const float c = cs[i % hd2], s = sn[i % hd2];
      p.qbuf[(size_t)b * QH + col] =
          __float2bfloat16(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
      p.qbuf[(size_t)b * QH + col + hd2] =
          __float2bfloat16(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
    }
    for (int i = threadIdx.x; i < hd2; i += THREADS) {
      const int col = QH + g * HD + i;
      const float x1 = val(col), x2 = val(col + hd2);
      kf[i] = bf(__fsub_rn(__fmul_rn(x1, cs[i]), __fmul_rn(x2, sn[i])));
      kf[i + hd2] = bf(__fadd_rn(__fmul_rn(x2, cs[i]), __fmul_rn(x1, sn[i])));
    }
    for (int i = threadIdx.x; i < HD; i += THREADS) vf[i] = val(QH + KH + g * HD + i);
    __syncthreads();
    float ak = 0.f, av = 0.f;
    for (int i = threadIdx.x; i < HD; i += THREADS) {
      ak = fmaxf(ak, fabsf(kf[i]));
      av = fmaxf(av, fabsf(vf[i]));
    }
    // the scale as a product with the f32 reciprocal of 127, the form in
    // which XLA evaluates the TPU kernel's quantizer; x / s stays a division
    const float sk = fmaxf(block_max(ak, red), 1e-8f) * (1.f / 127.f);
    const float sv = fmaxf(block_max(av, red), 1e-8f) * (1.f / 127.f);
    const size_t row = ((size_t)l * p.B + b) * KH + (size_t)g * HD;
    for (int i = threadIdx.x; i < HD; i += THREADS) {
      p.k_new[row + i] = static_cast<int8_t>(fminf(fmaxf(rintf(kf[i] / sk), -127.f), 127.f));
      p.v_new[row + i] = static_cast<int8_t>(fminf(fmaxf(rintf(vf[i] / sv), -127.f), 127.f));
    }
    if (threadIdx.x == 0) {
      p.ks_new[((size_t)l * p.B + b) * p.HKV + g] = sk;
      p.vs_new[((size_t)l * p.B + b) * p.HKV + g] = sv;
    }
    __syncthreads();
  }
}

// Per (request, kv head): attention over the cache slots [valid_from,
// q_slot) (K8: the request's keys [0, lengths[b]) through its block table)
// merged with the current token, -> attn (bf16); then, with write_cache,
// the new K/V land at `slot` of this cache row (K8: at the request's own
// write position).
template <bool kPaged>
static __device__ void attention_phase(const Params& p, int l, kv_attn::Smem& sm) {
  using kv_attn::GMAX;
  const int HD = p.HD, group = p.HQ / p.HKV;
  const int QH = p.HQ * HD, KH = p.HKV * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int it = blockIdx.x; it < p.B * p.HKV; it += gridDim.x) {
    const int b = it / p.HKV, g = it % p.HKV;
    const size_t lb = (size_t)l * p.B + b;
    const __nv_bfloat16* qg = p.qbuf + (size_t)b * QH + (size_t)g * group * HD;
    float acc[GMAX];
    bool write = false;
    int8_t* kw = nullptr;   // this item's write position: K, V codes, scales
    int8_t* vw = nullptr;
    float* ksw = nullptr;
    float* vsw = nullptr;
    if constexpr (kPaged) {
      const size_t page = (size_t)p.BS * KH, spage = (size_t)p.HKV * p.BS;
      int8_t* kv = p.kq + (size_t)l * p.NB * 2 * page + (size_t)g * HD;
      float* kvs = p.ks + (size_t)l * p.NB * 2 * spage + (size_t)g * p.BS;
      const int* table = p.tables + (size_t)b * p.MB;
      const kv_attn::PagedAddr addr{kv, kvs, table, p.BS, p.MB, (size_t)KH, page, spage};
      const int len = p.q_slot[b];
      kv_attn::attend<true>(qg, addr, 0, min(len, p.MB * p.BS) - 1, group, HD,
                            p.scale, sm, acc);
      if (p.write_cache) {
        // a stale length past the table (a retired row inside a horizon)
        // stays inside the request's own table row, as JAX clamps
        const size_t blk = (size_t)__ldg(table + min(len / p.BS, p.MB - 1));
        const int off = len % p.BS;
        write = true;
        kw = kv + blk * 2 * page + (size_t)off * KH;
        vw = kw + page;
        ksw = kvs + blk * 2 * spage + off;
        vsw = ksw + spage;
      }
    } else {
      const int S = p.S;
      int8_t* kbase = p.kq + lb * S * KH + (size_t)g * HD;
      int8_t* vbase = p.vq + lb * S * KH + (size_t)g * HD;
      float* ksb = p.ks + (lb * p.HKV + g) * S;
      float* vsb = p.vs + (lb * p.HKV + g) * S;
      const kv_attn::SlotAddr addr{kbase, vbase, ksb, vsb, (size_t)KH};
      kv_attn::attend<true>(qg, addr, max(p.valid_from[b], 0),
                            min(p.q_slot[b] - 1, S - 1), group, HD, p.scale, sm, acc);
      if (p.write_cache && p.slot >= 0 && p.slot < S) {
        write = true;
        kw = kbase + (size_t)p.slot * KH;
        vw = vbase + (size_t)p.slot * KH;
        ksw = ksb + p.slot;
        vsw = vsb + p.slot;
      }
    }

    // the current token, dequantized from the int8 values the cache holds
    const int8_t* kn = p.k_new + lb * KH + (size_t)g * HD;
    const int8_t* vn = p.v_new + lb * KH + (size_t)g * HD;
    const float ksc = __ldcg(p.ks_new + lb * p.HKV + g);
    const float vsc = __ldcg(p.vs_new + lb * p.HKV + g);
    for (int r = warp; r < group; r += NWARPS) {
      float dot = 0.f;
      for (int c = lane; c < HD; c += 32)
        dot += sm.q[r][c] * bf(static_cast<float>(__ldcg(kn + c)) * ksc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const float s_cur = dot * p.scale;
        const float m_new = fmaxf(sm.m[r], s_cur);
        const float alpha = expf(sm.m[r] - m_new);
        const float p_cur = expf(s_cur - m_new);
        sm.alpha[r] = alpha;
        sm.p[r][0] = p_cur;
        sm.l[r] = sm.l[r] * alpha + p_cur;
      }
    }
    __syncthreads();
    if (tid < HD) {
      const float v_cur = bf(static_cast<float>(__ldcg(vn + tid)) * vsc);
#pragma unroll
      for (int r = 0; r < GMAX; ++r) {
        if (r < group) {
          const float o = (acc[r] * sm.alpha[r] + sm.p[r][0] * v_cur) / sm.l[r];
          p.attn[(size_t)b * QH + (size_t)(g * group + r) * HD + tid] = __float2bfloat16(o);
        }
      }
    }
    if (write) {
      for (int c = tid; c < HD; c += THREADS) {
        kw[c] = __ldcg(kn + c);
        vw[c] = __ldcg(vn + c);
      }
      if (tid == 0) {
        *ksw = ksc;
        *vsw = vsc;
      }
    }
    __syncthreads();
  }
}

// ff = bf16(silu(bf16(gate)) * bf16(up)), gate/up = scale * partials.
static __device__ void silu_phase(const Params& p, int l) {
  const int F = p.F, N = 2 * F;
  const float* sc = p.sgu + (size_t)l * N;
  const size_t total = (size_t)p.B * F;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    const int b = static_cast<int>(i / F), n = static_cast<int>(i % F);
    const float gate = bf(partial_sum(p.ws, p.split_gu, p.B, N, b, n) * sc[n]);
    const float up = bf(partial_sum(p.ws, p.split_gu, p.B, N, b, F + n) * sc[F + n]);
    p.ff[i] = __float2bfloat16(gate / (1.f + expf(-gate)) * up);
  }
}

template <bool kPaged>
__global__ void __launch_bounds__(THREADS) fused_decode_kernel(Params p) {
  __shared__ __align__(128) unsigned char smem_raw[SMEM_BYTES];
  __shared__ float red[NWARPS];
  __shared__ float kv_sm[2 * kv_attn::DMAX];
  w8a16::Smem& tile = *reinterpret_cast<w8a16::Smem*>(smem_raw);
  kv_attn::Smem& att = *reinterpret_cast<kv_attn::Smem*>(smem_raw);
  cg::grid_group grid = cg::this_grid();

  const int D = p.D, F = p.F, QH = p.HQ * p.HD;
  const int QO = QH + 2 * p.HKV * p.HD;
  rows_phase(p, nullptr, 0, p.ln1, true, red);
  grid.sync();
  for (int l = 0; l < p.L; ++l) {
    gemm_partials(p.h, p.wqkv + (size_t)l * D * QO, p.ws, p.B, QO, D, p.split_qkv, tile);
    grid.sync();
    qkv_phase(p, l, red, kv_sm);
    grid.sync();
    attention_phase<kPaged>(p, l, att);
    grid.sync();
    gemm_partials(p.attn, p.wo + (size_t)l * QH * D, p.ws, p.B, D, QH, p.split_wo, tile);
    grid.sync();
    rows_phase(p, p.swo + (size_t)l * D, p.split_wo, p.ln2 + (size_t)l * D, false, red);
    grid.sync();
    gemm_partials(p.h, p.wgu + (size_t)l * D * 2 * F, p.ws, p.B, 2 * F, D, p.split_gu, tile);
    grid.sync();
    silu_phase(p, l);
    grid.sync();
    gemm_partials(p.ff, p.wdn + (size_t)l * F * D, p.ws, p.B, D, F, p.split_dn, tile);
    grid.sync();
    rows_phase(p, p.sdn + (size_t)l * D, p.split_dn,
               l + 1 < p.L ? p.ln1 + (size_t)(l + 1) * D : nullptr, false, red);
    if (l + 1 < p.L) grid.sync();
  }
}

static const void* kernel_of(int paged) {
  return paged ? reinterpret_cast<const void*>(&fused_decode_kernel<true>)
               : reinterpret_cast<const void*>(&fused_decode_kernel<false>);
}

static int launch(Params& p, int paged, int grid, void* stream) {
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel_of(paged), dim3(grid),
                                                dim3(THREADS), args, 0,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The weights, workspaces and outputs shared by K4 and K8.
static void set_common(Params& p, const void* x0, const void* ln1, const void* ln2,
                       const void* wqkv, const void* sqkv, const void* wo,
                       const void* swo, const void* wgu, const void* sgu,
                       const void* wdn, const void* sdn, const void* cos,
                       const void* sin, void* k_new, void* ks_new, void* v_new,
                       void* vs_new, void* x_out, void* xf, void* h, void* qbuf,
                       void* attn, void* ff, void* ws) {
  p.x0 = static_cast<const __nv_bfloat16*>(x0);
  p.ln1 = static_cast<const __nv_bfloat16*>(ln1);
  p.ln2 = static_cast<const __nv_bfloat16*>(ln2);
  p.wqkv = static_cast<const int8_t*>(wqkv);
  p.sqkv = static_cast<const float*>(sqkv);
  p.wo = static_cast<const int8_t*>(wo);
  p.swo = static_cast<const float*>(swo);
  p.wgu = static_cast<const int8_t*>(wgu);
  p.sgu = static_cast<const float*>(sgu);
  p.wdn = static_cast<const int8_t*>(wdn);
  p.sdn = static_cast<const float*>(sdn);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.k_new = static_cast<int8_t*>(k_new);
  p.ks_new = static_cast<float*>(ks_new);
  p.v_new = static_cast<int8_t*>(v_new);
  p.vs_new = static_cast<float*>(vs_new);
  p.x_out = static_cast<__nv_bfloat16*>(x_out);
  p.xf = static_cast<float*>(xf);
  p.h = static_cast<__nv_bfloat16*>(h);
  p.qbuf = static_cast<__nv_bfloat16*>(qbuf);
  p.attn = static_cast<__nv_bfloat16*>(attn);
  p.ff = static_cast<__nv_bfloat16*>(ff);
  p.ws = static_cast<float*>(ws);
}

}  // namespace

// The grid of one launch of K4 (paged = 0) or K8 (paged = 1): SMs x
// resident blocks of the kernel (a cooperative launch needs the whole grid
// resident). Returns cudaSuccess or the error.
extern "C" int pli_fused_decode_grid(int paged, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(paged),
                                                        THREADS, 0);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  *grid = sms * per_sm;
  return static_cast<int>(err);
}

// K4. Every pointer is contiguous on one device in the layouts of Params;
// the int8 cache rows and weight rows are 16-byte aligned, HD % 16 == 0,
// HD <= 128, HQ / HKV <= 8 (checked by the Python wrapper). splits are the
// k-splits of the four GEMM phases, ws holds max(split * B * N) floats.
// `grid` comes from pli_fused_decode_grid. Returns the launch's error code.
extern "C" int pli_fused_decode_step(
    const void* x0, const void* ln1, const void* ln2, const void* wqkv,
    const void* sqkv, const void* wo, const void* swo, const void* wgu,
    const void* sgu, const void* wdn, const void* sdn, void* kq, void* ks,
    void* vq, void* vs, const void* cos, const void* sin, const void* q_slot,
    const void* valid_from, void* k_new, void* ks_new, void* v_new,
    void* vs_new, void* x_out, void* xf, void* h, void* qbuf, void* attn,
    void* ff, void* ws, int L, int B, int S, int D, int F, int HQ, int HKV,
    int HD, int slot, int write_cache, int split_qkv, int split_wo,
    int split_gu, int split_dn, float eps, float scale, int grid,
    void* stream) {
  Params p;
  set_common(p, x0, ln1, ln2, wqkv, sqkv, wo, swo, wgu, sgu, wdn, sdn, cos, sin,
             k_new, ks_new, v_new, vs_new, x_out, xf, h, qbuf, attn, ff, ws);
  p.kq = static_cast<int8_t*>(kq);
  p.ks = static_cast<float*>(ks);
  p.vq = static_cast<int8_t*>(vq);
  p.vs = static_cast<float*>(vs);
  p.tables = nullptr;
  p.q_slot = static_cast<const int*>(q_slot);
  p.valid_from = static_cast<const int*>(valid_from);
  p.L = L; p.B = B; p.S = S; p.D = D; p.F = F;
  p.HQ = HQ; p.HKV = HKV; p.HD = HD;
  p.NB = 0; p.MB = 0; p.BS = 0;
  p.slot = slot; p.write_cache = write_cache;
  p.split_qkv = split_qkv; p.split_wo = split_wo;
  p.split_gu = split_gu; p.split_dn = split_dn;
  p.eps = eps; p.scale = scale;
  return launch(p, 0, grid, stream);
}

// K8. As K4, with the merged pools kv (L, NB, 2, BS, HKV*HD) int8 and kvs
// (L, NB, 2, HKV, BS) f32, lengths (B,) >= 0 and tables (B, MB) int32 whose
// entries are < NB; the pool rows are 16-byte aligned (HD % 16 == 0).
// inplace writes the new K/V into the pools. Returns the launch's error.
extern "C" int pli_fused_paged_decode_step(
    const void* x0, const void* ln1, const void* ln2, const void* wqkv,
    const void* sqkv, const void* wo, const void* swo, const void* wgu,
    const void* sgu, const void* wdn, const void* sdn, void* kv, void* kvs,
    const void* cos, const void* sin, const void* lengths, const void* tables,
    void* k_new, void* ks_new, void* v_new, void* vs_new, void* x_out,
    void* xf, void* h, void* qbuf, void* attn, void* ff, void* ws, int L,
    int B, int NB, int MB, int BS, int D, int F, int HQ, int HKV, int HD,
    int inplace, int split_qkv, int split_wo, int split_gu, int split_dn,
    float eps, float scale, int grid, void* stream) {
  Params p;
  set_common(p, x0, ln1, ln2, wqkv, sqkv, wo, swo, wgu, sgu, wdn, sdn, cos, sin,
             k_new, ks_new, v_new, vs_new, x_out, xf, h, qbuf, attn, ff, ws);
  p.kq = static_cast<int8_t*>(kv);
  p.ks = static_cast<float*>(kvs);
  p.vq = nullptr;
  p.vs = nullptr;
  p.tables = static_cast<const int*>(tables);
  p.q_slot = static_cast<const int*>(lengths);
  p.valid_from = nullptr;
  p.L = L; p.B = B; p.S = 0; p.D = D; p.F = F;
  p.HQ = HQ; p.HKV = HKV; p.HD = HD;
  p.NB = NB; p.MB = MB; p.BS = BS;
  p.slot = -1; p.write_cache = inplace;
  p.split_qkv = split_qkv; p.split_wo = split_wo;
  p.split_gu = split_gu; p.split_dn = split_dn;
  p.eps = eps; p.scale = scale;
  return launch(p, 1, grid, stream);
}
