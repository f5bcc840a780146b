// K3, forward: per-sample depthwise correlation with zero "same" padding,
//
//   y[b, v, c] = sum_t w[b, t, c] * xpad[b, v + off_t, c],
//
// on a channels-last volume x (B, S1, S2, S3, C), taps w (B, k1*k2*k3, C) in
// row-major order over the odd kernel sizes (k1, k2, k3), cross-correlation
// orientation.  The input gradient is this kernel again, on the cotangent and
// spatially flipped taps.
//
// Replaces the Pallas kernel `_fwd_kernel` (factorizer_tpu/ops/pallas/
// depthwise_packed.py:131, launched at :251) and the unpacked stencil
// `_fwd_kernel` of factorizer_tpu/ops/pallas/depthwise_conv.py:62 (launched at
// :134): two TPU layouts of one function.  The packed kernel stages a halo
// block (1, bs1 + 2 r1, bs2 + 2 r2, rows, 128) in VMEM and rolls lanes for the
// S3 taps; here the halo tile sits in shared memory and C may be any width.
//
// What bounds it on the H100: bytes.  It reads x and writes y once (1.07 GB at
// (2,128^3,32) f32, 0.32 ms at 3.35 TB/s) against 2 * taps flops per element
// (7.2 GFLOP, 0.11 ms on the f32 CUDA cores at 27 taps).
//
// What the design does about it (the tiled kernel):
// - A block owns t2 x t3 outputs of a plane and cb channels and walks `planes`
//   planes along S1.  It keeps a ring of k1 + 1 input planes of
//   (t2 + k2 - 1) x (t3 + k3 - 1) x cb in shared memory: each input plane comes
//   from memory once per block, and the next plane's copies (cp.async, 16
//   bytes each, zero-filled outside the volume, so no padded copy and no index
//   test in the products) are in flight while the block computes on the
//   current k1 planes.  At t2 = 8, t3 = 32 the halo reads 10 * 34 / 256 = 1.3x
//   the tile, from L2 where neighbouring blocks (neighbouring in blockIdx.x)
//   read it too.  The copies' addresses come from shifts and masks, not
//   divisions: a division per copy costs as many instructions as the products
//   that the copy feeds (0.75 against 0.58 ms at (2,128^3,32) f32 on an H100).
// - The block's taps are staged once in shared memory, not in registers (27
//   taps x 4 channels would take 108 of a thread's registers, which hold its
//   32 accumulators and a row of inputs); a warp's read of a tap is one
//   broadcast line.
// - A thread computes 4 channels x kTileRun (4) positions along S3 x
//   tile_rows(k2) (2) rows: per input row it reads kTileRun + k3 - 1 vectors
//   and uses each in up to k3 x 2 products.  Neighbouring threads take
//   neighbouring channel vectors, and a pad after each run of columns keeps a
//   warp's reads free of bank conflicts.
// - The launch plan (tile, channels per block, planes per block) is chosen per
//   shape by the wrapper from the SM count, so that the deep stages, with few
//   tiles, still give the card a few waves of blocks: it cuts the walk along S1
//   into chunks (each reloads k1 - 1 halo planes), then splits the channels
//   finer, then shortens the tile.
// - A 2-D image batch arrives as (B, H, 1, W, C) with kernel (kh, 1, kw): the
//   walk runs down the image rows.
// The products of each output run in tap order (k1, k2, k3 row-major), one f32
// fma each, for f32 or bf16 activations.
//
// Dispatch by shape (the wrapper chooses, the C entry checks): the tiled
// kernel takes k2, k3 in {1, 3, 5, 7}, any odd k1, and C divided by a
// 16-byte vector (4 f32 or 8 bf16 channels).  Other widths take the run
// kernel (a thread owns one channel and kRun outputs along S3 and reads its
// tap rows through L1; k3 in {1, 3, 5, 7}); any other odd k3 takes a
// one-output-per-thread kernel with run-time loops.
#include <cstdint>

#include "depthwise_conv.cuh"

namespace {

using ftt::kLanes;
using ftt::kRun;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kLanes;
using ftt::kRouteAny;
using ftt::kRouteRun;
using ftt::kRouteTile;

// The tiled kernel.  Grid: (S1 chunks x S2 tiles x S3 tiles, C / cb, B).
template <typename T, int K2, int K3>
__global__ void __launch_bounds__(ftt::kTileMaxThreads, ftt::tile_min_blocks(K2, K3, false))
depthwise_conv_tile_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y, int S1, int S2,
                           int S3, int C, int k1, ftt::TilePlan plan) {
  constexpr int Q = ftt::tile_rows(K2), R = ftt::kTileRun, W = R + K3 - 1, elt = sizeof(T);
  extern __shared__ __align__(16) char smem[];
  const ftt::TileAt at = ftt::tile_at(plan, S1, S2, S3);
  const int cb = plan.cb, CV = cb / ftt::kTileChannels, runs = plan.t3 / R;
  const int cv = threadIdx.x % CV, run = threadIdx.x / CV % runs, rg = threadIdx.x / (CV * runs);
  const int r1 = k1 / 2, taps = k1 * K2 * K3, slots = k1 + 1;
  const ftt::TileLayout lay(plan.t2 + K2 - 1, plan.t3 + K3 - 1, cb, elt);
  float* wt = reinterpret_cast<float*>(smem);
  char* ring = smem + ftt::round16(taps * cb * 4);
  const T* sample = x + static_cast<int64_t>(at.b) * S1 * S2 * S3 * C + at.c0;

  for (int i = threadIdx.x; i < taps * cb; i += blockDim.x)
    wt[i] = w[(static_cast<int64_t>(at.b) * taps + i / cb) * C + at.c0 + i % cb];
  // Plane j1 sits in slot (j1 - p0 + r1) % slots; planes outside the volume are neither loaded nor read.
  const int o2 = at.o2 - K2 / 2, o3 = at.o3 - K3 / 2, rows = plan.t2 + K2 - 1, cols = plan.t3 + K3 - 1;
  for (int j1 = max(at.p0 - r1, 0); j1 <= min(at.p0 + r1, S1 - 1); ++j1)
    ftt::load_tile(ring + (j1 - at.p0 + r1) % slots * lay.bytes, lay, sample, x, j1, o2, o3, rows, cols, S2, S3, C);
  ftt::cp_async_commit();

  // This thread's first position in a slot, and its taps.
  const int base = (rg * Q) * lay.row_bytes + run * (R * lay.col_bytes + lay.pad) + cv * ftt::kTileChannels * elt;
  const float* wv = wt + cv * ftt::kTileChannels;
  for (int i1 = at.p0; i1 < at.p1; ++i1) {
    __syncthreads();  // every thread is done with the slot that the next copy fills
    const int next = i1 + r1 + 1;
    if (i1 + 1 < at.p1 && next < S1)
      ftt::load_tile(ring + (next - at.p0 + r1) % slots * lay.bytes, lay, sample, x, next, o2, o3, rows, cols, S2, S3, C);
    ftt::cp_async_commit();
    ftt::cp_async_wait<1>();
    __syncthreads();  // planes i1 - r1 ... i1 + r1 have landed

    float4 acc[Q][R];
#pragma unroll
    for (int qq = 0; qq < Q; ++qq)
#pragma unroll
      for (int q = 0; q < R; ++q) acc[qq][q] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int a = 0; a < k1; ++a) {
      const int j1 = i1 + a - r1;
      if (j1 < 0 || j1 >= S1) continue;  // uniform over the block
      const char* src = ring + (j1 - at.p0 + r1) % slots * lay.bytes + base;
      const float* wa = wv + a * K2 * K3 * cb;
#pragma unroll
      for (int dd = 0; dd < Q + K2 - 1; ++dd) {
        float4 xv[W];
#pragma unroll
        for (int q = 0; q < W; ++q) xv[q] = ftt::lds4(src + dd * lay.row_bytes + q * lay.col_bytes + q / R * lay.pad, T());
#pragma unroll
        for (int qq = 0; qq < Q; ++qq) {
          const int d = dd - qq;
          if (d < 0 || d >= K2) continue;
#pragma unroll
          for (int e = 0; e < K3; ++e) {
            const float4 tap = *reinterpret_cast<const float4*>(wa + (d * K3 + e) * cb);
#pragma unroll
            for (int q = 0; q < R; ++q) ftt::fma4(acc[qq][q], tap, xv[q + e]);
          }
        }
      }
    }
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) {
      const int i2 = at.o2 + rg * Q + qq;
      if (i2 >= S2) continue;
      T* out = y + ((static_cast<int64_t>(at.b) * S1 + i1) * S2 + i2) * S3 * C + at.c0 + cv * ftt::kTileChannels;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i3 = at.o3 + run * R + q;
        if (i3 < S3) ftt::store4(out + static_cast<int64_t>(i3) * C, acc[qq][q]);
      }
    }
  }
  ftt::cp_async_wait<0>();
}

// The run kernel: any channel width, k3 in {1, 3, 5, 7}.  A thread owns one channel and kRun outputs along S3;
// the eight warps of a block sit on eight neighbouring S2 rows of one run, so their tap rows overlap in L1.
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
cudaError_t launch_run(const void* x, const float* w, void* y, int B, int S1, int S2, int S3, int C, int k1,
                       int k2, cudaStream_t stream) {
  const int runs = (S3 + kRun - 1) / kRun;
  const int units = S1 * S2 * runs;
  const dim3 grid((units + kWarps - 1) / kWarps, (C + kLanes - 1) / kLanes, B);
  depthwise_conv_kernel<T, K3><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), S1, S2, S3, C, k1, k2, runs, units);
  return cudaGetLastError();
}

template <typename T, int K2, int K3>
cudaError_t launch_tile(const void* x, const float* w, void* y, int B, int S1, int S2, int S3, int C, int k1,
                        const ftt::TilePlan& plan, cudaStream_t stream) {
  const int smem = ftt::tile_smem(plan, k1, K2, K3, sizeof(T), false);
  auto kernel = depthwise_conv_tile_kernel<T, K2, K3>;
  cudaError_t err = ftt::allow_tile_smem<depthwise_conv_tile_kernel<T, K2, K3>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(((S1 + plan.planes - 1) / plan.planes) * ((S2 + plan.t2 - 1) / plan.t2) *
                      ((S3 + plan.t3 - 1) / plan.t3),
                  C / plan.cb, B);
  kernel<<<grid, ftt::tile_threads(plan, k1, K2, false), smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), S1, S2, S3, C, k1, plan);
  return cudaGetLastError();
}

template <typename T, int K2>
cudaError_t tile_k3(const void* x, const float* w, void* y, int B, int S1, int S2, int S3, int C, int k1, int k3,
                    const ftt::TilePlan& p, cudaStream_t s) {
  switch (k3) {
    case 1: return launch_tile<T, K2, 1>(x, w, y, B, S1, S2, S3, C, k1, p, s);
    case 3: return launch_tile<T, K2, 3>(x, w, y, B, S1, S2, S3, C, k1, p, s);
    case 5: return launch_tile<T, K2, 5>(x, w, y, B, S1, S2, S3, C, k1, p, s);
    case 7: return launch_tile<T, K2, 7>(x, w, y, B, S1, S2, S3, C, k1, p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const float* w, void* y, int B, int S1, int S2, int S3, int C, int k1,
                     int k2, int k3, int route, const ftt::TilePlan& p, cudaStream_t s) {
  if (route == kRouteTile) {
    if (!ftt::tile_plan_ok(p, S1, S2, S3, C, k1, k2, k3, sizeof(T), false)) return cudaErrorInvalidValue;
    switch (k2) {
      case 1: return tile_k3<T, 1>(x, w, y, B, S1, S2, S3, C, k1, k3, p, s);
      case 3: return tile_k3<T, 3>(x, w, y, B, S1, S2, S3, C, k1, k3, p, s);
      case 5: return tile_k3<T, 5>(x, w, y, B, S1, S2, S3, C, k1, k3, p, s);
      case 7: return tile_k3<T, 7>(x, w, y, B, S1, S2, S3, C, k1, k3, p, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (route == kRouteRun) {
    switch (k3) {
      case 1: return launch_run<T, 1>(x, w, y, B, S1, S2, S3, C, k1, k2, s);
      case 3: return launch_run<T, 3>(x, w, y, B, S1, S2, S3, C, k1, k2, s);
      case 5: return launch_run<T, 5>(x, w, y, B, S1, S2, S3, C, k1, k2, s);
      case 7: return launch_run<T, 7>(x, w, y, B, S1, S2, S3, C, k1, k2, s);
      default: return cudaErrorInvalidValue;
    }
  }
  const int64_t voxels = static_cast<int64_t>(S1) * S2 * S3;
  const dim3 grid(static_cast<unsigned>((voxels + kWarps - 1) / kWarps), (C + kLanes - 1) / kLanes, B);
  depthwise_conv_any_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), w, static_cast<T*>(y),
                                                          S1, S2, S3, C, k1, k2, k3, voxels);
  return cudaGetLastError();
}

}  // namespace

// x, y: (B, S1, S2, S3, C) contiguous, of `dtype`, 16-byte aligned; w: (B, k1*k2*k3, C) f32, taps row-major
// over (k1, k2, k3), all odd.  `route`: 0 the tiled kernel with the plan (t2, t3, cb, planes), which it checks
// (tile_plan_ok); 1 the run kernel (k3 in {1, 3, 5, 7}); 2 the one-output-per-thread kernel.  The plan is
// ignored by routes 1 and 2.  B <= 65535, C <= 65535 * 32 and S1 * S2 * S3 < 2^31 (the grid's limits).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments that no route takes.
extern "C" int ftt_depthwise_conv(const void* x, const void* w, void* y, int dtype, int B, int S1, int S2,
                                  int S3, int C, int k1, int k2, int k3, int route, int t2, int t3, int cb,
                                  int planes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto fw = static_cast<const float*>(w);
  const ftt::TilePlan plan{t2, t3, cb, planes};
  cudaError_t err;
  if (B <= 0 || S1 <= 0 || S2 <= 0 || S3 <= 0 || C <= 0 || B > 65535 || !(k1 & 1) || !(k2 & 1) ||
      !(k3 & 1) || k1 <= 0 || k2 <= 0 || k3 <= 0 || route < kRouteTile || route > kRouteAny) {
    err = cudaErrorInvalidValue;
  } else if (dtype == ftt::kFloat32) {
    err = dispatch<float>(x, fw, y, B, S1, S2, S3, C, k1, k2, k3, route, plan, s);
  } else if (dtype == ftt::kBFloat16) {
    err = dispatch<__nv_bfloat16>(x, fw, y, B, S1, S2, S3, C, k1, k2, k3, route, plan, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// What the wrapper's mirror of depthwise_conv.cuh (ops/kernels/depthwise_conv.py) must agree with, for
// chip_smoke.py to hold it against: out[0..4] = kTileRun, kTileChannels, kTileMaxThreads, kSmemLimit,
// kDwTileTaps; out[5] = tile_min_blocks(k2, k3, dw); out[6] = the plan's shared memory in bytes (tile_smem), or
// -1 where tile_plan_ok refuses the plan.  elt: bytes of an activation (4 or 2).  Returns 0.
extern "C" int ftt_depthwise_conv_tile_query(int S1, int S2, int S3, int C, int k1, int k2, int k3, int elt,
                                             int dw, int t2, int t3, int cb, int planes, int* out) {
  const ftt::TilePlan plan{t2, t3, cb, planes};
  out[0] = ftt::kTileRun;
  out[1] = ftt::kTileChannels;
  out[2] = ftt::kTileMaxThreads;
  out[3] = ftt::kSmemLimit;
  out[4] = ftt::kDwTileTaps;
  out[5] = ftt::tile_min_blocks(k2, k3, dw != 0);
  out[6] = ftt::tile_plan_ok(plan, S1, S2, S3, C, k1, k2, k3, elt, dw != 0)
               ? ftt::tile_smem(plan, k1, k2, k3, elt, dw != 0)
               : -1;
  return 0;
}
