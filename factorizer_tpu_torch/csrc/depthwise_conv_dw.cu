// K3, weight gradient: for the cotangent g of y = depthwise_conv(x, w),
//
//   dw[b, t, c] = sum_v g[b, v, c] * xpad[b, v + off_t, c],
//
// x and g channels-last (B, S1, S2, S3, C), dw (B, k1*k2*k3, C) f32, taps
// row-major over the odd kernel sizes, zero "same" padding.  A 2-D image batch
// comes in as S1 = 1, k1 = 1.
//
// Replaces the Pallas kernel `_dw_kernel` (factorizer_tpu/ops/pallas/
// depthwise_packed.py:147, launched at :299) and the unpacked stencil's
// `_dw_kernel` (factorizer_tpu/ops/pallas/depthwise_conv.py:79, launched at
// :174).  The TPU kernels add into a revisited output block because their grid
// runs in order; CUDA blocks run concurrently, so the sum over every voxel of a
// sample is taken in two passes.
//
// What bounds it on the H100: bytes.  It reads x and g once (1.07 GB at
// (2,128^3,32) f32, 0.32 ms at 3.35 TB/s) against 2 * taps flops per element.
//
// What the design does about it: the thread layout of the forward kernel (a
// warp over 32 neighbouring channels, a run of kRun positions along S3 per
// thread, the warps of a block on neighbouring rows).  A thread keeps its run
// of g in registers, loads each tap row's kRun + k3 - 1 inputs once, and adds
// the row's k3 products into accumulators that it carries across its walk over
// the sample: the grid is capped, block p of a sample takes units p, p + P, ...
// After the walk a block sums its eight warps in shared memory, in warp order,
// and writes one partial set (taps x C) into a scratch; a second kernel adds the
// partial sets in block order.  No atomics: the order of every sum is fixed, so
// the gradient is the same from run to run.  The accumulators are indexed at
// compile time (kRows tap rows x k3): a 3^3 or a 1x7x7 kernel fits one chunk of
// rows, larger k1*k2 take further chunks along the grid, each re-reading g.
// k3 in {1, 3, 5, 7} is compiled in; any other odd k3 takes a kernel that walks
// the sample once per tap.
#include <cstdint>

#include "depthwise_conv.cuh"

namespace {

using ftt::kLanes;
using ftt::kRun;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kLanes;
constexpr int kRows = 9;  // tap rows (k1*k2) per chunk

// partials[((b * P + p) * taps + t) * C + c]
template <typename T, int K3>
__global__ void __launch_bounds__(kThreads)
depthwise_conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partials,
                         int S1, int S2, int S3, int C, int k1, int k2, int runs, int units, int chunks) {
  constexpr int R3 = K3 / 2, W = kRun + K3 - 1;
  __shared__ float red[kWarps][K3][kLanes];
  const int lane = threadIdx.x & (kLanes - 1), warp = threadIdx.x >> 5;
  const int c = blockIdx.y * kLanes + lane;
  const int b = blockIdx.z / chunks, row0 = (blockIdx.z % chunks) * kRows;
  const int n_rows = k1 * k2, r1 = k1 / 2, r2 = k2 / 2;
  const int P = gridDim.x;

  float acc[kRows][K3];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int kk = 0; kk < K3; ++kk) acc[rr][kk] = 0.f;

  if (c < C) {
    const int64_t sample = static_cast<int64_t>(b) * S1 * S2 * S3 * C + c;
    for (int u = blockIdx.x * kWarps + warp; u < units; u += P * kWarps) {
      const ftt::Unit at = ftt::unit_of(u, S2, runs);
      const T* grow = g + sample + (static_cast<int64_t>(at.i1) * S2 + at.i2) * S3 * C;
      float gv[kRun];
#pragma unroll
      for (int q = 0; q < kRun; ++q)
        gv[q] = at.s0 + q < S3 ? ftt::to_float(grow[static_cast<int64_t>(at.s0 + q) * C]) : 0.f;
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const int row = row0 + rr;
        if (row < n_rows) {
          const int j1 = at.i1 + row / k2 - r1, j2 = at.i2 + row % k2 - r2;
          if (j1 >= 0 && j1 < S1 && j2 >= 0 && j2 < S2) {
            const T* xrow = x + sample + (static_cast<int64_t>(j1) * S2 + j2) * S3 * C;
            float xv[W];
#pragma unroll
            for (int q = 0; q < W; ++q) {
              const int j3 = at.s0 + q - R3;
              xv[q] = (j3 >= 0 && j3 < S3) ? ftt::to_float(xrow[static_cast<int64_t>(j3) * C]) : 0.f;
            }
#pragma unroll
            for (int kk = 0; kk < K3; ++kk)
#pragma unroll
              for (int q = 0; q < kRun; ++q) acc[rr][kk] = fmaf(gv[q], xv[q + kk], acc[rr][kk]);
          }
        }
      }
    }
  }

  // The block's eight warps, summed in warp order; warp kk writes tap kk of each row.
  const int taps = n_rows * K3;
  float* mine = partials + (static_cast<int64_t>(b) * P + blockIdx.x) * taps * C;
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int row = row0 + rr;
    if (row >= n_rows) break;  // uniform over the block
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < K3; ++kk) red[warp][kk][lane] = acc[rr][kk];
    __syncthreads();
    if (warp < K3 && c < C) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) s += red[v][warp][lane];
      mine[static_cast<int64_t>(row * K3 + warp) * C + c] = s;
    }
  }
}

// Any odd k3: block (p, channel chunk, b * taps + t) walks the sample for one tap.
template <typename T>
__global__ void __launch_bounds__(kThreads)
depthwise_conv_dw_any_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partials,
                             int S1, int S2, int S3, int C, int k1, int k2, int k3, int64_t voxels) {
  __shared__ float red[kWarps][kLanes];
  const int lane = threadIdx.x & (kLanes - 1), warp = threadIdx.x >> 5;
  const int c = blockIdx.y * kLanes + lane;
  const int taps = k1 * k2 * k3;
  const int b = blockIdx.z / taps, t = blockIdx.z % taps;
  const int o1 = t / (k2 * k3) - k1 / 2, o2 = (t / k3) % k2 - k2 / 2, o3 = t % k3 - k3 / 2;
  const int P = gridDim.x;
  float acc = 0.f;
  if (c < C) {
    const int64_t sample = static_cast<int64_t>(b) * voxels * C + c;
    for (int64_t v = static_cast<int64_t>(blockIdx.x) * kWarps + warp; v < voxels;
         v += static_cast<int64_t>(P) * kWarps) {
      const int j3 = static_cast<int>(v % S3) + o3;
      const int j2 = static_cast<int>((v / S3) % S2) + o2;
      const int j1 = static_cast<int>(v / S3 / S2) + o1;
      if (j1 < 0 || j1 >= S1 || j2 < 0 || j2 >= S2 || j3 < 0 || j3 >= S3) continue;
      const int64_t at = (static_cast<int64_t>(j1) * S2 + j2) * S3 + j3;
      acc = fmaf(ftt::to_float(g[sample + v * C]), ftt::to_float(x[sample + at * C]), acc);
    }
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < C) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += red[v][lane];
    partials[((static_cast<int64_t>(b) * P + blockIdx.x) * taps + t) * C + c] = s;
  }
}

// dw[b, i] = sum over the sample's P partial sets, in block order; i runs over taps * C.
__global__ void __launch_bounds__(kThreads)
sum_dw_partials_kernel(const float* __restrict__ partials, float* __restrict__ dw, int P, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* src = partials + static_cast<int64_t>(blockIdx.y) * P * n + i;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += src[static_cast<int64_t>(p) * n];
  dw[static_cast<int64_t>(blockIdx.y) * n + i] = s;
}

template <typename T, int K3>
cudaError_t launch(const void* x, const void* g, float* partials, int B, int S1, int S2, int S3, int C,
                   int k1, int k2, int P, cudaStream_t stream) {
  const int runs = (S3 + kRun - 1) / kRun;
  const int units = S1 * S2 * runs;
  const int chunks = (k1 * k2 + kRows - 1) / kRows;
  const dim3 grid(P, (C + kLanes - 1) / kLanes, B * chunks);
  depthwise_conv_dw_kernel<T, K3><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partials, S1, S2, S3, C, k1, k2, runs, units, chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, float* partials, int B, int S1, int S2, int S3, int C,
                     int k1, int k2, int k3, int P, cudaStream_t s) {
  switch (k3) {
    case 1: return launch<T, 1>(x, g, partials, B, S1, S2, S3, C, k1, k2, P, s);
    case 3: return launch<T, 3>(x, g, partials, B, S1, S2, S3, C, k1, k2, P, s);
    case 5: return launch<T, 5>(x, g, partials, B, S1, S2, S3, C, k1, k2, P, s);
    case 7: return launch<T, 7>(x, g, partials, B, S1, S2, S3, C, k1, k2, P, s);
    default: break;
  }
  const dim3 grid(P, (C + kLanes - 1) / kLanes, B * k1 * k2 * k3);
  depthwise_conv_dw_any_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partials, S1, S2, S3, C, k1, k2, k3,
      static_cast<int64_t>(S1) * S2 * S3);
  return cudaGetLastError();
}

}  // namespace

// x, g: (B, S1, S2, S3, C) contiguous, of `dtype`; partials: (B, P, taps, C) f32
// scratch; dw: (B, taps, C) f32; taps = k1*k2*k3 row-major, all odd.  P is the
// number of blocks that share one sample's voxels (P >= 1).  The grid's limits:
// B * ceil(k1*k2 / 9) <= 65535 (B * taps for a k3 above 7), S1 * S2 * S3 < 2^31.
// Returns cudaGetLastError().
extern "C" int ftt_depthwise_conv_dw(const void* x, const void* g, void* partials, void* dw, int dtype,
                                     int B, int S1, int S2, int S3, int C, int k1, int k2, int k3, int P,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto fp = static_cast<float*>(partials);
  cudaError_t err;
  if (B <= 0 || S1 <= 0 || S2 <= 0 || S3 <= 0 || C <= 0 || P <= 0 || !(k1 & 1) || !(k2 & 1) || !(k3 & 1) ||
      k1 <= 0 || k2 <= 0 || k3 <= 0) {
    err = cudaErrorInvalidValue;
  } else if (dtype == ftt::kFloat32) {
    err = dispatch<float>(x, g, fp, B, S1, S2, S3, C, k1, k2, k3, P, s);
  } else if (dtype == ftt::kBFloat16) {
    err = dispatch<__nv_bfloat16>(x, g, fp, B, S1, S2, S3, C, k1, k2, k3, P, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = k1 * k2 * k3 * C;
  const dim3 grid((n + kThreads - 1) / kThreads, B);
  sum_dw_partials_kernel<<<grid, kThreads, 0, s>>>(fp, static_cast<float*>(dw), P, n);
  return static_cast<int>(cudaGetLastError());
}
