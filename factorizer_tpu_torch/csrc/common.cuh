// Helpers shared by the port's kernels: dtype conversion and a block sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ftt {

// Activation dtypes the kernels take; the codes match the Python wrappers.
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

// Sum of `v` over the block, returned to every thread.  `red` holds 33
// floats of shared memory; blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // `red` may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    float t = lane < nwarps ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// The K sums of `v[0..K)` over the block, returned to every thread in `v`.
// `red` holds 9 * K floats of shared memory; blockDim.x is a multiple of 32,
// at least K and at most 256.  The sum runs warp by warp in a fixed order.
template <int K>
__device__ __forceinline__ void block_sum_vec(float (&v)[K], float* red) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // `red` may still be read from a previous call
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    const int nwarps = blockDim.x >> 5;
    float t = 0.f;
    for (int w = 0; w < nwarps; ++w) t += red[w * K + threadIdx.x];
    red[8 * K + threadIdx.x] = t;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = red[8 * K + k];
}

}  // namespace ftt
