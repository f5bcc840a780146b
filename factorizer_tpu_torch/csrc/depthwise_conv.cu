// K3, forward: per-sample depthwise correlation with zero "same" padding,
//
//   y[b, v, c] = sum_t w[b, t, c] * xpad[b, v + off_t, c],
//
// on a channels-last volume x (B, S1, S2, S3, C), taps w (B, k1*k2*k3, C) in
// row-major order over the odd kernel sizes (k1, k2, k3), cross-correlation
// orientation.  A 2-D image batch comes in as S1 = 1, k1 = 1.  The input
// gradient is this kernel again, on the cotangent and spatially flipped taps.
//
// Replaces the Pallas kernel `_fwd_kernel` (factorizer_tpu/ops/pallas/
// depthwise_packed.py:131, launched at :251) and the unpacked stencil
// `_fwd_kernel` of factorizer_tpu/ops/pallas/depthwise_conv.py:62 (launched at
// :134): two TPU layouts of one function.  Their lane packing, rolls and
// padded copies serve the TPU's 128-lane vector unit and have no counterpart
// here; C may be any width.
//
// What bounds it on the H100: bytes.  It reads x and writes y once (1.07 GB at
// (2,128^3,32) f32, 0.32 ms at 3.35 TB/s) against 2 * taps flops per element
// (7.2 GFLOP, 0.11 ms on the f32 CUDA cores at 27 taps).
//
// What the design does about it: channels are the contiguous axis, so a warp
// takes 32 neighbouring channels and every load is one full line.  A thread
// owns a run of kRun outputs along S3: per tap row it loads kRun + k3 - 1
// inputs into registers once and uses each in up to k3 products, and the k3
// taps of the row come from the (B, taps, C) table through L1.  The eight warps
// of a block sit on eight neighbouring S2 rows of one run, so the k2 rows each
// of them reads overlap and mostly hit L1; the k1 planes overlap between blocks
// and hit L2.  The border is an index test: rows outside the volume are skipped
// whole, positions outside S3 read as zero.  Accumulation is f32 for either
// activation dtype.  k3 in {1, 3, 5, 7} is compiled in; any other odd k3 takes a
// one-output-per-thread kernel with run-time loops.
#include <cstdint>

#include "depthwise_conv.cuh"

namespace {

using ftt::kLanes;
using ftt::kRun;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kLanes;

template <typename T, int K3>
__global__ void __launch_bounds__(kThreads)
depthwise_conv_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y, int S1,
                      int S2, int S3, int C, int k1, int k2, int runs, int units) {
  constexpr int R3 = K3 / 2, W = kRun + K3 - 1;
  const int c = blockIdx.y * kLanes + (threadIdx.x & (kLanes - 1));
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.z;
  if (c >= C || u >= units) return;
  const ftt::Unit at = ftt::unit_of(u, S2, runs);
  const int r1 = k1 / 2, r2 = k2 / 2;
  const float* wb = w + static_cast<int64_t>(b) * k1 * k2 * K3 * C + c;

  float acc[kRun];
#pragma unroll
  for (int q = 0; q < kRun; ++q) acc[q] = 0.f;

  for (int a = 0; a < k1; ++a) {
    const int j1 = at.i1 + a - r1;
    if (j1 < 0 || j1 >= S1) continue;
    for (int d = 0; d < k2; ++d) {
      const int j2 = at.i2 + d - r2;
      if (j2 < 0 || j2 >= S2) continue;
      const T* row = x + ((static_cast<int64_t>(b) * S1 + j1) * S2 + j2) * S3 * C + c;
      float xv[W];
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const int j3 = at.s0 + q - R3;
        xv[q] = (j3 >= 0 && j3 < S3) ? ftt::to_float(row[static_cast<int64_t>(j3) * C]) : 0.f;
      }
      const float* wr = wb + static_cast<int64_t>((a * k2 + d) * K3) * C;
#pragma unroll
      for (int kk = 0; kk < K3; ++kk) {
        const float wv = wr[static_cast<int64_t>(kk) * C];
#pragma unroll
        for (int q = 0; q < kRun; ++q) acc[q] = fmaf(wv, xv[q + kk], acc[q]);
      }
    }
  }

  T* out = y + ((static_cast<int64_t>(b) * S1 + at.i1) * S2 + at.i2) * S3 * C + c;
#pragma unroll
  for (int q = 0; q < kRun; ++q)
    if (at.s0 + q < S3) out[static_cast<int64_t>(at.s0 + q) * C] = ftt::from_float<T>(acc[q]);
}

// Any odd k3: one output per thread, every loop at run time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
depthwise_conv_any_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y, int S1,
                          int S2, int S3, int C, int k1, int k2, int k3, int64_t voxels) {
  const int c = blockIdx.y * kLanes + (threadIdx.x & (kLanes - 1));
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.z;
  if (c >= C || v >= voxels) return;
  const int i3 = static_cast<int>(v % S3);
  const int i2 = static_cast<int>((v / S3) % S2);
  const int i1 = static_cast<int>(v / S3 / S2);
  const float* wb = w + static_cast<int64_t>(b) * k1 * k2 * k3 * C + c;
  const T* xb = x + static_cast<int64_t>(b) * voxels * C + c;
  float acc = 0.f;
  for (int a = 0; a < k1; ++a) {
    const int j1 = i1 + a - k1 / 2;
    if (j1 < 0 || j1 >= S1) continue;
    for (int d = 0; d < k2; ++d) {
      const int j2 = i2 + d - k2 / 2;
      if (j2 < 0 || j2 >= S2) continue;
      for (int e = 0; e < k3; ++e) {
        const int j3 = i3 + e - k3 / 2;
        if (j3 < 0 || j3 >= S3) continue;
        const int64_t at = (static_cast<int64_t>(j1) * S2 + j2) * S3 + j3;
        acc = fmaf(wb[static_cast<int64_t>((a * k2 + d) * k3 + e) * C], ftt::to_float(xb[at * C]), acc);
      }
    }
  }
  y[(static_cast<int64_t>(b) * voxels + v) * C + c] = ftt::from_float<T>(acc);
}

template <typename T, int K3>
cudaError_t launch(const void* x, const float* w, void* y, int B, int S1, int S2, int S3, int C, int k1,
                   int k2, cudaStream_t stream) {
  const int runs = (S3 + kRun - 1) / kRun;
  const int units = S1 * S2 * runs;
  const dim3 grid((units + kWarps - 1) / kWarps, (C + kLanes - 1) / kLanes, B);
  depthwise_conv_kernel<T, K3><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), S1, S2, S3, C, k1, k2, runs, units);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* w, void* y, int B, int S1, int S2, int S3, int C, int k1,
                     int k2, int k3, cudaStream_t s) {
  switch (k3) {
    case 1: return launch<T, 1>(x, w, y, B, S1, S2, S3, C, k1, k2, s);
    case 3: return launch<T, 3>(x, w, y, B, S1, S2, S3, C, k1, k2, s);
    case 5: return launch<T, 5>(x, w, y, B, S1, S2, S3, C, k1, k2, s);
    case 7: return launch<T, 7>(x, w, y, B, S1, S2, S3, C, k1, k2, s);
    default: break;
  }
  const int64_t voxels = static_cast<int64_t>(S1) * S2 * S3;
  const dim3 grid(static_cast<unsigned>((voxels + kWarps - 1) / kWarps), (C + kLanes - 1) / kLanes, B);
  depthwise_conv_any_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), w, static_cast<T*>(y),
                                                          S1, S2, S3, C, k1, k2, k3, voxels);
  return cudaGetLastError();
}

}  // namespace

// x, y: (B, S1, S2, S3, C) contiguous, of `dtype`; w: (B, k1*k2*k3, C) f32,
// taps row-major over (k1, k2, k3), all odd.  B <= 65535, C <= 65535 * 32 and
// S1 * S2 * S3 < 2^31 (the grid's limits).  Returns cudaGetLastError().
extern "C" int ftt_depthwise_conv(const void* x, const void* w, void* y, int dtype, int B, int S1, int S2,
                                  int S3, int C, int k1, int k2, int k3, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto fw = static_cast<const float*>(w);
  cudaError_t err;
  if (B <= 0 || S1 <= 0 || S2 <= 0 || S3 <= 0 || C <= 0 || B > 65535 || !(k1 & 1) || !(k2 & 1) ||
      !(k3 & 1) || k1 <= 0 || k2 <= 0 || k3 <= 0) {
    err = cudaErrorInvalidValue;
  } else if (dtype == ftt::kFloat32) {
    err = dispatch<float>(x, fw, y, B, S1, S2, S3, C, k1, k2, k3, s);
  } else if (dtype == ftt::kBFloat16) {
    err = dispatch<__nv_bfloat16>(x, fw, y, B, S1, S2, S3, C, k1, k2, k3, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
