// K12: elementwise add, out = a + b, over (N, C) arrays in f32 or bf16.
//
// Replaces the TPU kernel physics_llm_inference_tpu/kernels/hello_pallas.py
// (vector_add -> _add_kernel), the one-kernel template: row blocks of 256
// staged through VMEM and added on the VPU.
//
// Bound on the H100: bytes. One add per 12 (f32) or 6 (bf16) bytes moved, so
// the only work is to stream a and b in and out at full bandwidth. One
// 16-byte vector of a and of b a thread (4 f32 or 8 bf16) and one thread a
// vector, with no grid-stride loop, as PyTorch's vectorized elementwise
// kernel launches. On the H100 this was faster than four vectors a thread in
// flight with streaming cache hints, than 16 KB tiles of a and b staged
// through shared memory by cp.async.bulk and added there, and than a
// grid-stride loop of 16 blocks an SM (PERF.md, K12). What is not a whole
// 16-byte vector (and the whole array when a pointer is not 16-byte aligned)
// is added one element a thread. bf16 is summed in f32 and rounded once to
// bf16, as torch.add does, so the two are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the nvec whole 16-byte vectors, one a thread
template <typename T>
__global__ void __launch_bounds__(THREADS)
vector_add_vec(const uint4* __restrict__ a, const uint4* __restrict__ b,
               uint4* __restrict__ out, long long nvec) {
  constexpr int E = 16 / sizeof(T);
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= nvec) return;
  const uint4 va = a[i], vb = b[i];
  const T* ea = reinterpret_cast<const T*>(&va);
  const T* eb = reinterpret_cast<const T*>(&vb);
  uint4 vo;
  T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
  for (int e = 0; e < E; ++e) eo[e] = from_f32<T>(to_f32(ea[e]) + to_f32(eb[e]));
  out[i] = vo;
}

// the elements [from, n) one a thread (the tail, or everything unaligned)
template <typename T>
__global__ void __launch_bounds__(THREADS)
vector_add_scalar(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                  long long from, long long n) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = from + (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride)
    out[i] = from_f32<T>(to_f32(a[i]) + to_f32(b[i]));
}

template <typename T>
int launch(const T* a, const T* b, T* out, long long n, int vec, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const long long nvec = vec ? n / E : 0;
  if (nvec > 0) {
    const long long grid = (nvec + THREADS - 1) / THREADS;
    vector_add_vec<T><<<(unsigned)grid, THREADS, 0, st>>>(
        reinterpret_cast<const uint4*>(a), reinterpret_cast<const uint4*>(b),
        reinterpret_cast<uint4*>(out), nvec);
  }
  const long long rest = n - nvec * E;
  if (rest > 0) {
    long long blocks = (rest + THREADS - 1) / THREADS;
    if (blocks > 132 * 16) blocks = 132 * 16;
    vector_add_scalar<T><<<(unsigned)blocks, THREADS, 0, st>>>(a, b, out, nvec * E, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, out: n contiguous elements of one dtype (0: f32, 1: bf16). vec = 1
// when all three pointers are 16-byte aligned. Returns cudaGetLastError().
extern "C" int pli_vector_add(const void* a, const void* b, void* out,
                              long long n, int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(static_cast<const float*>(a), static_cast<const float*>(b),
                  static_cast<float*>(out), n, vec, st);
  return launch(static_cast<const __nv_bfloat16*>(a),
                static_cast<const __nv_bfloat16*>(b),
                static_cast<__nv_bfloat16*>(out), n, vec, st);
}
