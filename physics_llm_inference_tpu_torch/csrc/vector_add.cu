// K12: elementwise add, out = a + b, over (N, C) arrays in f32 or bf16.
//
// Replaces the TPU kernel physics_llm_inference_tpu/kernels/hello_pallas.py
// (vector_add -> _add_kernel), the one-kernel template: row blocks of 256
// staged through VMEM and added on the VPU.
//
// Bound on the H100: bytes. One add per 12 (f32) or 6 (bf16) bytes moved, so
// the only work is to stream a and b in and out at full bandwidth. A grid-
// stride loop over 16-byte vectors (4 f32 or 8 bf16 a thread per load),
// neighbouring threads on neighbouring vectors, a few blocks per SM with
// enough loads in flight; the row blocks of the TPU kernel have no
// counterpart. A scalar tail covers what is not a whole vector (and the
// whole array when a pointer is not 16-byte aligned). bf16 is summed in f32
// and rounded once to bf16, as torch.add does, so the two are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T>
__global__ void __launch_bounds__(256)
vector_add_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ out, long long n, int vec) {
  constexpr int E = 16 / sizeof(T);   // elements in a 16-byte vector
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = vec ? n / E : 0;
  for (long long i = tid; i < nvec; i += stride) {
    const uint4 va = __ldg(reinterpret_cast<const uint4*>(a) + i);
    const uint4 vb = __ldg(reinterpret_cast<const uint4*>(b) + i);
    const T* ea = reinterpret_cast<const T*>(&va);
    const T* eb = reinterpret_cast<const T*>(&vb);
    uint4 vo;
    T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
    for (int e = 0; e < E; ++e) eo[e] = from_f32<T>(to_f32(ea[e]) + to_f32(eb[e]));
    reinterpret_cast<uint4*>(out)[i] = vo;
  }
  for (long long i = nvec * E + tid; i < n; i += stride) {
    out[i] = from_f32<T>(to_f32(a[i]) + to_f32(b[i]));
  }
}

}  // namespace

// a, b, out: n contiguous elements of one dtype (0: f32, 1: bf16). vec = 1
// when all three pointers are 16-byte aligned. Returns cudaGetLastError().
extern "C" int pli_vector_add(const void* a, const void* b, void* out,
                              long long n, int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long per = vec ? (dtype == 0 ? 4 : 8) : 1;
  long long blocks = (n / per + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // 16 blocks a SM, then stride
  if (blocks < 1) blocks = 1;
  if (dtype == 0) {
    vector_add_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), n, vec);
  } else {
    vector_add_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), n, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
