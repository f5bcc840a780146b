// Shared by the depthwise-convolution kernels (K3): the tiled kernels' plan and
// shared-memory layout, their 16-byte copies, and the run kernels' decomposition.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ftt {

// Which kernel a call takes, chosen by shape in the Python wrapper: the tiled kernel, the run kernel, or the
// one-output-per-thread kernel.
enum K3Route : int { kRouteTile = 0, kRouteRun = 1, kRouteAny = 2 };

// ---- The tiled kernels (channel widths that a 16-byte vector divides, kernel sizes 1/3/5/7 along S2, S3).

// Outputs along S3 that one thread computes: it reads kTileRun + k3 - 1 inputs of a row from shared memory and
// uses each in up to k3 products.
constexpr int kTileRun = 4;
// Channels one thread computes: 16 bytes of f32 or 8 of bf16 or f16 from shared memory at a time.
constexpr int kTileChannels = 4;
constexpr int kTileMaxThreads = 256;
constexpr int kSmemLimit = 232448;  // 227 KB, the most one block of an H100 can take
// The weight gradient's accumulators a thread holds (k2 * k3 float4s) at most.
constexpr int kDwTileTaps = 16;

// Blocks of kTileMaxThreads threads that one SM must be able to hold at once: the second argument of the tiled
// kernels' __launch_bounds__, so a thread gets at most 65536 / (kTileMaxThreads * blocks) registers, 128 at two
// blocks.  The wrapper's plan counts the blocks an SM holds from this cap, not from what ptxas chose.  A weight
// gradient with more than 9 accumulators needs more than 128 registers, and gets one block.
__host__ __device__ constexpr int tile_min_blocks(int k2, int k3, bool dw) { return dw && k2 * k3 > 9 ? 1 : 2; }

// Rows along S2 that one thread computes: two reuse each input row of a k2 > 1 stencil in two outputs.
__host__ __device__ constexpr int tile_rows(int k2) { return k2 > 1 ? 2 : 1; }

// Chosen per shape by the Python wrapper (`ops/kernels/depthwise_conv.py::conv_plan`): a block owns t2 x t3
// outputs of a plane (S2 x S3) and cb channels, and walks `planes` planes along S1.  t2 is a multiple of
// tile_rows(k2), t3 of kTileRun, and cb a power of two of at least 16 bytes that divides C.
struct TilePlan {
  int t2, t3, cb, planes;
};

// A tile of rows x cols positions x cb channels in shared memory, channels innermost.  Position (row, col)
// starts at row * row_bytes + col * col_bytes + (col / kTileRun) * pad.  The pad after every run of kTileRun
// columns puts the runs that neighbouring threads read into different banks when a column is narrower than a
// 128-byte phase of a warp's load (the run stride is then 5 columns, and 5 is odd).
struct TileLayout {
  int col_bytes, pad, row_bytes, bytes;
  __host__ __device__ TileLayout(int rows, int cols, int cb, int elt) {
    col_bytes = cb * elt;
    pad = col_bytes < 128 ? col_bytes : 0;
    row_bytes = cols * col_bytes + (cols + kTileRun - 1) / kTileRun * pad;
    bytes = rows * row_bytes;
  }
  __host__ __device__ int at(int row, int col) const {
    return row * row_bytes + col * col_bytes + col / kTileRun * pad;
  }
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// Threads of a block: channel vectors x runs x row groups, times the tap planes k1 for the weight gradient.
__host__ __device__ inline int tile_threads(const TilePlan& p, int k1, int k2, bool dw) {
  return p.cb / kTileChannels * (p.t3 / kTileRun) * (p.t2 / tile_rows(k2)) * (dw ? k1 : 1);
}

// Shared memory of a block.  Forward: the block's taps (f32), then a ring of k1 + 1 input planes with their
// halo: the k1 planes of the current output plane and the next one in flight.  Weight gradient: the ring, then
// two cotangent planes without halo; after the walk the same memory holds every thread's accumulators for the
// block's sum.
__host__ __device__ inline int tile_smem(const TilePlan& p, int k1, int k2, int k3, int elt, bool dw) {
  const int ring = (k1 + 1) * TileLayout(p.t2 + k2 - 1, p.t3 + k3 - 1, p.cb, elt).bytes;
  if (!dw) return round16(k1 * k2 * k3 * p.cb * 4) + ring;
  const int walk = ring + 2 * TileLayout(p.t2, p.t3, p.cb, elt).bytes;
  const int sums = tile_threads(p, k1, k2, true) * k2 * k3 * kTileChannels * 4;
  return walk > sums ? walk : sums;
}

// Whether the tiled kernels take this plan: the layout's constraints and CUDA's limits.
inline bool tile_plan_ok(const TilePlan& p, int S1, int S2, int S3, int C, int k1, int k2, int k3, int elt,
                         bool dw) {
  const int vec = 16 / elt;
  if ((dw && k2 * k3 > kDwTileTaps) || p.t2 <= 0 || p.t3 <= 0 || p.cb <= 0 || p.planes <= 0 || p.t2 % tile_rows(k2) || p.t3 % kTileRun ||
      p.cb % vec || p.cb % kTileChannels || C % p.cb || (p.cb & (p.cb - 1)))
    return false;
  const int threads = tile_threads(p, k1, k2, dw);
  const int64_t blocks = static_cast<int64_t>((S1 + p.planes - 1) / p.planes) * ((S2 + p.t2 - 1) / p.t2) *
                         ((S3 + p.t3 - 1) / p.t3);
  return threads >= 1 && threads <= kTileMaxThreads && blocks < (int64_t(1) << 31) && C / p.cb <= 65535 &&
         tile_smem(p, k1, k2, k3, elt, dw) <= kSmemLimit;
}

// Lets `Kernel` take up to kSmemLimit bytes of dynamic shared memory, once per device and not at every launch
// (the attribute call costs the host microseconds that the deep stages' launches do not have).
template <auto Kernel>
inline cudaError_t allow_tile_smem() {
  static unsigned done = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess) done |= bit;
  return err;
}

// 16 bytes from global to shared memory, asynchronously; `src_bytes` = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N> __device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;" ::"n"(N)); }

// Four channels from shared memory, as f32.
__device__ __forceinline__ float4 lds4(const char* p, float) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 lds4(const char* p, __nv_bfloat16) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u), __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float4 lds4(const char* p, __half) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void fma4(float4& acc, const float4& a, const float4& b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

// Four channels to global memory.
__device__ __forceinline__ void store4(float* p, const float4& v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store4(__half* p, const float4& v) {
  const __half2 lo = __floats2half2_rn(v.x, v.y), hi = __floats2half2_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// A block's place in the tiled grid: blockIdx.x runs over (S1 chunk, S2 tile, S3 tile) with the S3 tile
// innermost, so neighbouring blocks walk neighbouring tiles of the same planes and share their halos in L2.
struct TileAt {
  int o2, o3, p0, p1, c0, b;
};

__device__ __forceinline__ TileAt tile_at(const TilePlan& p, int S1, int S2, int S3) {
  const int tiles3 = (S3 + p.t3 - 1) / p.t3, tiles2 = (S2 + p.t2 - 1) / p.t2;
  int u = blockIdx.x;
  TileAt t;
  t.o3 = u % tiles3 * p.t3;
  u /= tiles3;
  t.o2 = u % tiles2 * p.t2;
  t.p0 = u / tiles2 * p.planes;
  t.p1 = min(t.p0 + p.planes, S1);
  t.c0 = blockIdx.y * p.cb;
  t.b = blockIdx.z;
  return t;
}

// Issue the copies of plane j1's tile rows x cols (offset (o2, o3)) of one sample into `dst`: 16 bytes a copy,
// zeros where the tile leaves the volume.  `sample` points at (b, 0, 0, 0, c0).  Copy (row, v) is the v-th 16-byte
// chunk of a row: column v >> shift, chunk v & mask (a column is cb * elt = a power of two of chunks), so a row's
// chunks lie at consecutive places of shared memory apart from the pad after every run of columns.  The block's
// threads step through the rows x chunks by blockDim.x with one carry, since a division a copy would cost as many
// instructions as the products that the copy feeds.
template <typename T>
__device__ __forceinline__ void load_tile(char* dst, const TileLayout& lay, const T* __restrict__ sample,
                                          const T* __restrict__ any, int j1, int o2, int o3, int rows, int cols,
                                          int S2, int S3, int C) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const int shift = __ffs(lay.col_bytes / 16) - 1, mask = (1 << shift) - 1, per_row = cols << shift;
  const int srow = blockDim.x / per_row, sv = blockDim.x % per_row;
  int row = threadIdx.x / per_row, v = threadIdx.x % per_row;
  const T* plane = sample + static_cast<int64_t>(j1) * S2 * S3 * C;
  for (; row < rows;) {
    const int col = v >> shift, j2 = o2 + row, j3 = o3 + col;
    const bool in = j2 >= 0 && j2 < S2 && j3 >= 0 && j3 < S3;
    const T* src = in ? plane + (static_cast<int64_t>(j2) * S3 + j3) * C + (v & mask) * kPer : any;
    cp_async16(dst + row * lay.row_bytes + v * 16 + col / kTileRun * lay.pad, src, in ? 16 : 0);
    v += sv;
    row += srow;
    if (v >= per_row) {
      v -= per_row;
      ++row;
    }
  }
}

// ---- The run kernels (any channel width, k3 in {1, 3, 5, 7}): the tiled kernels' fallback by shape.

// Consecutive positions along the innermost spatial axis that one thread owns.
// A thread reads kRun + k3 - 1 inputs per tap row and reuses each in up to k3
// products, so a 3-tap row costs 1.25 loads per output instead of 3.
constexpr int kRun = 8;
// Channels per warp: neighbouring threads take neighbouring channels, the
// contiguous axis, so a warp's load is one 128-byte line in f32.
constexpr int kLanes = 32;

// A unit is one run of one row, numbered (i1, run, i2) with i2 innermost: the
// warps of a block then sit on neighbouring rows of one run, and the tap rows
// they read overlap, so most of a block's loads hit L1.
struct Unit {
  int i1, i2, s0;
};

__device__ __forceinline__ Unit unit_of(int u, int S2, int runs) {
  Unit t;
  t.i2 = u % S2;
  u /= S2;
  t.s0 = (u % runs) * kRun;
  t.i1 = u / runs;
  return t;
}

}  // namespace ftt
