// K3, weight gradient: for the cotangent g of y = depthwise_conv(x, w),
//
//   dw[b, t, c] = sum_v g[b, v, c] * xpad[b, v + off_t, c],
//
// x and g channels-last (B, S1, S2, S3, C), dw (B, k1*k2*k3, C) f32, taps
// row-major over the odd kernel sizes, zero "same" padding.
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
// What the design does about it (the tiled kernel):
// - The forward's tile walk (depthwise_conv.cu): a block owns t2 x t3
//   positions of a plane and cb channels, walks `planes` planes along S1, and
//   keeps a ring of k1 + 1 x planes with their halo in shared memory, the next
//   plane's copies (cp.async, zero-filled outside the volume) in flight behind
//   the products.  The g tile has no halo; two g planes take turns.  So x and g
//   each come from memory about once.
// - A thread owns one tap plane a (of k1), 4 channels, kTileRun positions
//   along S3 and tile_rows(k2) rows: it reads its g values once per plane and
//   each x row once, and adds k2 x k3 x 4 accumulators, which stay in
//   registers over the whole walk.
// - After the walk the block adds its threads' accumulators in shared memory,
//   in a fixed order, and writes one partial set (taps x cb); a second kernel
//   adds a sample's partial sets in block order, eight slices of blocks a
//   column summed in order and then the slices in order.  No atomics: the
//   order of every sum is fixed, so the gradient is the same from run to run.
// - The wrapper's launch plan (depthwise_conv.py::conv_plan) sets the tile,
//   the channels per block and the planes per block per shape, so that the deep
//   stages still give the card a few waves of blocks; the partial sets a
//   sample are the plan's blocks per sample.
//
// Dispatch by shape (the wrapper chooses, the C entry checks): the tiled
// kernel takes k2, k3 in {1, 3, 5, 7} with k2 * k3 <= 16 (the accumulators
// a thread holds), any odd k1, and C divided by a 16-byte vector.  Other
// shapes with k3 in {1, 3, 5, 7} take the run kernel (a thread owns one
// channel and kRun positions, the forward run kernel's layout, its tap rows
// in chunks of kRows); any other odd k3 takes a kernel that walks the sample
// once per tap.
#include <cstdint>

#include "depthwise_conv.cuh"

namespace {

using ftt::kLanes;
using ftt::kRouteAny;
using ftt::kRouteRun;
using ftt::kRouteTile;
using ftt::kRun;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kLanes;
constexpr int kRows = 9;  // tap rows (k1*k2) per chunk of the run kernel

// The tiled kernel.  Grid: (S1 chunks x S2 tiles x S3 tiles = P, C / cb, B); block p of sample b writes
// partials[((b * P + p) * taps + t) * C + c] for its cb channels.
template <typename T, int K2, int K3>
__global__ void __launch_bounds__(ftt::kTileMaxThreads, ftt::tile_min_blocks(K2, K3, true))
depthwise_conv_dw_tile_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partials,
                              int S1, int S2, int S3, int C, int k1, ftt::TilePlan plan) {
  constexpr int Q = ftt::tile_rows(K2), R = ftt::kTileRun, W = R + K3 - 1, KK = K2 * K3, elt = sizeof(T);
  extern __shared__ __align__(16) char smem[];
  const ftt::TileAt at = ftt::tile_at(plan, S1, S2, S3);
  const int cb = plan.cb, CV = cb / ftt::kTileChannels, runs = plan.t3 / R, rgs = plan.t2 / Q;
  const int cv = threadIdx.x % CV, run = threadIdx.x / CV % runs, rg = threadIdx.x / (CV * runs) % rgs;
  const int a = threadIdx.x / (CV * runs * rgs);
  const int r1 = k1 / 2, slots = k1 + 1;
  const ftt::TileLayout lay(plan.t2 + K2 - 1, plan.t3 + K3 - 1, cb, elt), glay(plan.t2, plan.t3, cb, elt);
  char* ring = smem;
  char* gbuf = smem + slots * lay.bytes;
  const int64_t offset = static_cast<int64_t>(at.b) * S1 * S2 * S3 * C + at.c0;
  const T* xs = x + offset;
  const T* gs = g + offset;

  // x plane j1 sits in slot (j1 - p0 + r1) % slots, g plane i1 in slot (i1 - p0) % 2.
  const int o2 = at.o2 - K2 / 2, o3 = at.o3 - K3 / 2, rows = plan.t2 + K2 - 1, cols = plan.t3 + K3 - 1;
  for (int j1 = max(at.p0 - r1, 0); j1 <= min(at.p0 + r1, S1 - 1); ++j1)
    ftt::load_tile(ring + (j1 - at.p0 + r1) % slots * lay.bytes, lay, xs, x, j1, o2, o3, rows, cols, S2, S3, C);
  ftt::load_tile(gbuf, glay, gs, g, at.p0, at.o2, at.o3, plan.t2, plan.t3, S2, S3, C);
  ftt::cp_async_commit();

  const int chan = cv * ftt::kTileChannels * elt;
  const int xbase = (rg * Q) * lay.row_bytes + run * (R * lay.col_bytes + lay.pad) + chan;
  const int gbase = (rg * Q) * glay.row_bytes + run * (R * glay.col_bytes + glay.pad) + chan;
  float4 acc[KK];
#pragma unroll
  for (int t = 0; t < KK; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i1 = at.p0; i1 < at.p1; ++i1) {
    __syncthreads();  // every thread is done with the slots that the next copies fill
    if (i1 + 1 < at.p1) {
      const int next = i1 + r1 + 1;
      if (next < S1)
        ftt::load_tile(ring + (next - at.p0 + r1) % slots * lay.bytes, lay, xs, x, next, o2, o3, rows, cols, S2, S3, C);
      ftt::load_tile(gbuf + (i1 + 1 - at.p0) % 2 * glay.bytes, glay, gs, g, i1 + 1, at.o2, at.o3, plan.t2, plan.t3,
                     S2, S3, C);
    }
    ftt::cp_async_commit();
    ftt::cp_async_wait<1>();
    __syncthreads();  // x planes i1 - r1 ... i1 + r1 and g plane i1 have landed

    const int j1 = i1 + a - r1;
    if (j1 < 0 || j1 >= S1) continue;
    const char* gsrc = gbuf + (i1 - at.p0) % 2 * glay.bytes + gbase;
    float4 gv[Q][R];
#pragma unroll
    for (int qq = 0; qq < Q; ++qq)
#pragma unroll
      for (int q = 0; q < R; ++q) gv[qq][q] = ftt::lds4(gsrc + qq * glay.row_bytes + q * glay.col_bytes, T());
    const char* xsrc = ring + (j1 - at.p0 + r1) % slots * lay.bytes + xbase;
#pragma unroll
    for (int dd = 0; dd < Q + K2 - 1; ++dd) {
      float4 xv[W];
#pragma unroll
      for (int q = 0; q < W; ++q) xv[q] = ftt::lds4(xsrc + dd * lay.row_bytes + q * lay.col_bytes + q / R * lay.pad, T());
#pragma unroll
      for (int qq = 0; qq < Q; ++qq) {
        const int d = dd - qq;
        if (d < 0 || d >= K2) continue;
#pragma unroll
        for (int e = 0; e < K3; ++e)
#pragma unroll
          for (int q = 0; q < R; ++q) ftt::fma4(acc[d * K3 + e], gv[qq][q], xv[q + e]);
      }
    }
  }
  ftt::cp_async_wait<0>();
  __syncthreads();  // the walk is over everywhere: the ring becomes the block's sum

  // sums[((rr * k1 + a) * KK + t) * cb + c], rr = the thread's (row group, run); then each (a, t, c) of the
  // block adds its rr values in order.
  float* sums = reinterpret_cast<float*>(smem);
  const int n = k1 * KK * cb, rr = rg * runs + run, nr = rgs * runs;
#pragma unroll
  for (int t = 0; t < KK; ++t)
    *reinterpret_cast<float4*>(sums + (static_cast<int64_t>(rr * k1 + a) * KK + t) * cb + cv * ftt::kTileChannels) =
        acc[t];
  __syncthreads();
  float* mine = partials + (static_cast<int64_t>(at.b) * gridDim.x + blockIdx.x) * (k1 * KK) * C + at.c0;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    float s = 0.f;
    for (int v = 0; v < nr; ++v) s += sums[v * n + o];
    mine[static_cast<int64_t>(o / cb) * C + o % cb] = s;
  }
}

// The run kernel (any channel width, k3 in {1, 3, 5, 7}): the forward run kernel's thread layout, a grid of P
// blocks a sample, block p taking units p, p + P, ...; partials[((b * P + p) * taps + t) * C + c].
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

// dw[b, i] = sum over the sample's P partial sets, i over taps * C.  Block (i / kSumOut, b): thread (slice,
// column) sums sets slice, slice + kSumSlices, ... in order; then the slices are added in order.
constexpr int kSumOut = 32, kSumSlices = kThreads / kSumOut;

__global__ void __launch_bounds__(kThreads)
sum_dw_partials_kernel(const float* __restrict__ partials, float* __restrict__ dw, int P, int n) {
  __shared__ float part[kSumSlices][kSumOut];
  const int o = threadIdx.x % kSumOut, slice = threadIdx.x / kSumOut;
  const int i = blockIdx.x * kSumOut + o;
  float s = 0.f;
  if (i < n) {
    const float* src = partials + static_cast<int64_t>(blockIdx.y) * P * n + i;
#pragma unroll 4
    for (int p = slice; p < P; p += kSumSlices) s += src[static_cast<int64_t>(p) * n];
  }
  part[slice][o] = s;
  __syncthreads();
  if (slice == 0 && i < n) {
#pragma unroll
    for (int v = 1; v < kSumSlices; ++v) s += part[v][o];
    dw[static_cast<int64_t>(blockIdx.y) * n + i] = s;
  }
}

template <typename T, int K3>
cudaError_t launch_run(const void* x, const void* g, float* partials, int B, int S1, int S2, int S3, int C,
                       int k1, int k2, int P, cudaStream_t stream) {
  const int runs = (S3 + kRun - 1) / kRun;
  const int units = S1 * S2 * runs;
  const int chunks = (k1 * k2 + kRows - 1) / kRows;
  const dim3 grid(P, (C + kLanes - 1) / kLanes, B * chunks);
  depthwise_conv_dw_kernel<T, K3><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partials, S1, S2, S3, C, k1, k2, runs, units, chunks);
  return cudaGetLastError();
}

template <typename T, int K2, int K3>
cudaError_t launch_tile(const void* x, const void* g, float* partials, int B, int S1, int S2, int S3, int C,
                        int k1, const ftt::TilePlan& plan, cudaStream_t stream) {
  const int smem = ftt::tile_smem(plan, k1, K2, K3, sizeof(T), true);
  auto kernel = depthwise_conv_dw_tile_kernel<T, K2, K3>;
  cudaError_t err = ftt::allow_tile_smem<depthwise_conv_dw_tile_kernel<T, K2, K3>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(((S1 + plan.planes - 1) / plan.planes) * ((S2 + plan.t2 - 1) / plan.t2) *
                      ((S3 + plan.t3 - 1) / plan.t3),
                  C / plan.cb, B);
  kernel<<<grid, ftt::tile_threads(plan, k1, K2, true), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partials, S1, S2, S3, C, k1, plan);
  return cudaGetLastError();
}

template <typename T, int K2>
cudaError_t tile_k3(const void* x, const void* g, float* partials, int B, int S1, int S2, int S3, int C, int k1,
                    int k3, const ftt::TilePlan& p, cudaStream_t s) {
  switch (k3) {  // k2 * k3 <= 16
    case 1: return launch_tile<T, K2, 1>(x, g, partials, B, S1, S2, S3, C, k1, p, s);
    case 3:
      if constexpr (K2 <= 5) return launch_tile<T, K2, 3>(x, g, partials, B, S1, S2, S3, C, k1, p, s);
      return cudaErrorInvalidValue;
    case 5:
      if constexpr (K2 <= 3) return launch_tile<T, K2, 5>(x, g, partials, B, S1, S2, S3, C, k1, p, s);
      return cudaErrorInvalidValue;
    case 7:
      if constexpr (K2 == 1) return launch_tile<T, K2, 7>(x, g, partials, B, S1, S2, S3, C, k1, p, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, float* partials, int B, int S1, int S2, int S3, int C,
                     int k1, int k2, int k3, int route, const ftt::TilePlan& p, int P, cudaStream_t s) {
  if (route == kRouteTile) {
    const int blocks = ((S1 + p.planes - 1) / p.planes) * ((S2 + p.t2 - 1) / p.t2) * ((S3 + p.t3 - 1) / p.t3);
    if (!ftt::tile_plan_ok(p, S1, S2, S3, C, k1, k2, k3, sizeof(T), true) || P != blocks)
      return cudaErrorInvalidValue;
    switch (k2) {
      case 1: return tile_k3<T, 1>(x, g, partials, B, S1, S2, S3, C, k1, k3, p, s);
      case 3: return tile_k3<T, 3>(x, g, partials, B, S1, S2, S3, C, k1, k3, p, s);
      case 5: return tile_k3<T, 5>(x, g, partials, B, S1, S2, S3, C, k1, k3, p, s);
      case 7: return tile_k3<T, 7>(x, g, partials, B, S1, S2, S3, C, k1, k3, p, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (B * ((k1 * k2 + kRows - 1) / kRows) > 65535) return cudaErrorInvalidValue;
  if (route == kRouteRun) {
    switch (k3) {
      case 1: return launch_run<T, 1>(x, g, partials, B, S1, S2, S3, C, k1, k2, P, s);
      case 3: return launch_run<T, 3>(x, g, partials, B, S1, S2, S3, C, k1, k2, P, s);
      case 5: return launch_run<T, 5>(x, g, partials, B, S1, S2, S3, C, k1, k2, P, s);
      case 7: return launch_run<T, 7>(x, g, partials, B, S1, S2, S3, C, k1, k2, P, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (B * k1 * k2 * k3 > 65535) return cudaErrorInvalidValue;
  const dim3 grid(P, (C + kLanes - 1) / kLanes, B * k1 * k2 * k3);
  depthwise_conv_dw_any_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partials, S1, S2, S3, C, k1, k2, k3,
      static_cast<int64_t>(S1) * S2 * S3);
  return cudaGetLastError();
}

}  // namespace

// x, g: (B, S1, S2, S3, C) contiguous, of `dtype`, 16-byte aligned; partials: (B, P, taps, C) f32 scratch;
// dw: (B, taps, C) f32; taps = k1*k2*k3 row-major, all odd.  `route` as in ftt_depthwise_conv: 0 the tiled
// kernel with the plan (t2, t3, cb, planes), whose blocks per sample P must be; 1 the run kernel and 2 the
// per-tap kernel, with P blocks a sample (P >= 1).  The grid's limits: B <= 65535 and, for routes 1 and 2,
// B * ceil(k1*k2 / 9) (B * taps for route 2) <= 65535; S1 * S2 * S3 < 2^31.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments that no route takes.
extern "C" int ftt_depthwise_conv_dw(const void* x, const void* g, void* partials, void* dw, int dtype,
                                     int B, int S1, int S2, int S3, int C, int k1, int k2, int k3, int route,
                                     int t2, int t3, int cb, int planes, int P, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto fp = static_cast<float*>(partials);
  const ftt::TilePlan plan{t2, t3, cb, planes};
  cudaError_t err;
  if (B <= 0 || S1 <= 0 || S2 <= 0 || S3 <= 0 || C <= 0 || P <= 0 || B > 65535 || !(k1 & 1) || !(k2 & 1) ||
      !(k3 & 1) || k1 <= 0 || k2 <= 0 || k3 <= 0 || route < kRouteTile || route > kRouteAny) {
    err = cudaErrorInvalidValue;
  } else if (dtype == ftt::kFloat32) {
    err = dispatch<float>(x, g, fp, B, S1, S2, S3, C, k1, k2, k3, route, plan, P, s);
  } else if (dtype == ftt::kBFloat16) {
    err = dispatch<__nv_bfloat16>(x, g, fp, B, S1, S2, S3, C, k1, k2, k3, route, plan, P, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = k1 * k2 * k3 * C;
  const dim3 grid((n + kSumOut - 1) / kSumOut, B);
  sum_dw_partials_kernel<<<grid, kThreads, 0, s>>>(fp, static_cast<float*>(dw), P, n);
  return static_cast<int>(cudaGetLastError());
}
