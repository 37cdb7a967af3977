// K10 and K11: row-block copies of the memory-access microbenchmark.
//
// Replaces the TPU kernels physics_llm_inference_tpu/kernels/membench.py
// _stream_copy (K10: every row block of 2048 rows, in order) and
// _strided_copy (K11: 8 rows out of every 32 * 8), both _copy_kernel, a VMEM
// block copied through the DMA engines. One kernel covers both: output row
// block i (block_bytes bytes) is input row block i * stride. Stride 1 is the
// contiguous stream, stride 32 the strided gather.
//
// Bound on the H100: bytes, and nothing else: a copy does no arithmetic.
// The kernel works on bytes, 16 at a time (uint4), so it is the same for
// every dtype. Each CUDA block copies one tile of THREADS * UNROLL vectors
// of one row block, with UNROLL loads in flight a thread before the first
// store, so enough bytes are in flight to cover device memory's latency
// (~2 MB over the card). Neighbouring threads touch neighbouring vectors:
// a strided row block is still UNROLL * 4 KB of contiguous bytes, fully
// coalesced, so unlike the TPU's strided DMA the H100 pays little for the
// stride beyond the launch and the shorter runs. A row block that is not a
// whole number of vectors (or a pointer that is not 16-byte aligned) is
// copied byte by byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

template <typename U>
__global__ void __launch_bounds__(THREADS)
row_block_copy_kernel(const U* __restrict__ x, U* __restrict__ out,
                      long long units_per_block, long long stride,
                      long long tiles_per_block) {
  constexpr long long TILE = (long long)THREADS * UNROLL;
  const long long tile = blockIdx.x;
  const long long blk = tile / tiles_per_block;
  const long long base = (tile % tiles_per_block) * TILE + threadIdx.x;
  const U* src = x + blk * stride * units_per_block;
  U* dst = out + blk * units_per_block;
  U v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long j = base + (long long)u * THREADS;
    if (j < units_per_block) v[u] = src[j];
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long j = base + (long long)u * THREADS;
    if (j < units_per_block) dst[j] = v[u];
  }
}

template <typename U>
int launch(const void* x, void* out, long long num_blocks,
           long long block_bytes, long long stride, cudaStream_t st) {
  const long long units = block_bytes / (long long)sizeof(U);
  const long long tile = (long long)THREADS * UNROLL;
  const long long tiles_per_block = (units + tile - 1) / tile;
  const long long grid = num_blocks * tiles_per_block;
  if (grid > 0) {
    row_block_copy_kernel<U><<<(unsigned)grid, THREADS, 0, st>>>(
        static_cast<const U*>(x), static_cast<U*>(out), units, stride,
        tiles_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out row block i (block_bytes bytes) = x row block i * stride, for i in
// [0, num_blocks). vec = 1 when block_bytes is a multiple of 16 and both
// pointers are 16-byte aligned. Returns cudaGetLastError().
extern "C" int pli_row_block_copy(const void* x, void* out,
                                  long long num_blocks, long long block_bytes,
                                  long long stride, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch<uint4>(x, out, num_blocks, block_bytes, stride, st)
             : launch<unsigned char>(x, out, num_blocks, block_bytes, stride,
                                     st);
}
