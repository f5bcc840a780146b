// What the forward and the backward kernels of K1 and of K5 (K1 on a slab of
// a volume cut along S1) share: a window and where its elements lie, the
// forward solve (a register-resident one for the bundles' sizes, a
// shared-memory one for the others), and the sum over shift passes.  The
// column sum and the output pass also serve the flat kernels (nmf_bwd.cu).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ftt {

constexpr int kWindowThreads = 256;
// Most shifts one K1 forward launch takes (they travel by value in `Shifts`);
// a call with more launches once per group of them.
constexpr int kMaxShifts = 8;

struct Shifts {
  int n;
  int s[kMaxShifts][3];
};

// The (sample, window, head) of matrix `m` (default: blockIdx.x) for one
// shift pass.  Matrices are numbered sample-major, head fastest.  kD / kP > 0
// fix head_dim / patch at compile time, which turns the index arithmetic into
// shifts and masks; 0 takes the runtime d / p.
//
// kSlab: the tensor is one slab of S1 rows of a volume cut along its first
// spatial axis.  A window row that starts at -sh1 then reaches into the left
// neighbour's last sh1 rows, which the caller holds in a halo buffer
// (B, sh1, S2, S3, C): `offset` returns -1 - (offset in that buffer) for such
// an element, and the pass's value for it goes to a send buffer of the same
// shape (`load_at`, `store_at`).  Dims 2 and 3 are whole and wrap in place.
template <int kD, int kP, bool kSlab = false>
struct Window {
  static constexpr bool kHalo = kSlab;
  int d, p, P3, S1, S2, S3, C, c0, o1, o2, o3, h1;
  int64_t b;

  __device__ Window(int d_rt, int p_rt, int S1_, int S2_, int S3_, int C_, int sh1, int sh2, int sh3,
                    int64_t m = -1)
      : d(kD > 0 ? kD : d_rt), p(kP > 0 ? kP : p_rt), S1(S1_), S2(S2_), S3(S3_), C(C_), h1(sh1) {
    P3 = p * p * p;
    const int heads = C / d;
    const int G1 = S1 / p, G2 = S2 / p, G3 = S3 / p;
    int64_t blk = m < 0 ? static_cast<int64_t>(blockIdx.x) : m;
    c0 = static_cast<int>(blk % heads) * d; blk /= heads;
    o3 = static_cast<int>(blk % G3) * p - sh3; blk /= G3;
    o2 = static_cast<int>(blk % G2) * p - sh2; blk /= G2;
    o1 = static_cast<int>(blk % G1) * p - sh1; blk /= G1;
    b = blk;
  }

  // Where channel 0 of row q = (a1, a2, a3), a1-major, lies.  The rolled
  // coordinate i maps to the volume coordinate (i - s) mod S for both the
  // read and the write; i - s > -p >= -S, so one conditional add wraps it.
  __device__ int64_t row_offset(int q) const {
    const int a1 = q / (p * p), a2 = (q / p) % p, a3 = q % p;
    int c1 = o1 + a1, c2 = o2 + a2, c3 = o3 + a3;
    c2 += c2 < 0 ? S2 : 0;
    c3 += c3 < 0 ? S3 : 0;
    if (kSlab) {
      if (c1 < 0) return -1 - ((((b * h1 + c1 + h1) * S2 + c2) * S3 + c3) * C + c0);
    } else {
      c1 += c1 < 0 ? S1 : 0;
    }
    return (((b * S1 + c1) * S2 + c2) * S3 + c3) * C + c0;
  }

  // Element e of the window is (q, di) with di fastest.  Only a slab's
  // addressing has places below 0 (in the halo), which count down.
  __device__ int64_t offset(int e) const {
    if constexpr (kSlab) return channel_at(row_offset(e / d), e % d);
    return row_offset(e / d) + e % d;
  }

  // Element e as (row q, column di) of the block's matrix, and where it lies.
  __device__ int64_t locate(int e, int& q, int& di) const {
    q = e / d;
    di = e % d;
    return offset(e);
  }

  // Channel di of the row at `o` (a halo place counts down).
  __device__ static int64_t channel_at(int64_t o, int di) { return o < 0 ? o - di : o + di; }
};

// One shift pass's value `y` for the element at `o`: the first pass starts
// the f32 scratch `acc`, the middle ones add to it, the last scales the sum
// and casts it into `out`.  The passes are separate launches on one stream,
// so the sum has a fixed order and needs no atomics.  The forward's callers
// (K5's slab pass) hand in a product already rounded by __fmul_rn, which no
// FMA can absorb, so the chain rounds as K1's reconstruct pass does.
template <typename T>
__device__ __forceinline__ void store_pass(float* acc, T* out, int64_t o, float y, int first, int last,
                                           float scale) {
  if (first && last) {
    out[o] = from_float<T>(y * scale);
  } else if (first) {
    acc[o] = y;
  } else if (!last) {
    acc[o] += y;
  } else {
    out[o] = from_float<T>((acc[o] + y) * scale);
  }
}

// The input at the place `o` that an addressing `Addr` gave: in the tensor,
// or, for a slab's window that reaches into the left neighbour, in the halo.
template <typename Addr, typename T>
__device__ __forceinline__ float load_at(const T* __restrict__ x, const T* __restrict__ halo, int64_t o) {
  if constexpr (Addr::kHalo) {
    if (o < 0) return to_float(halo[-1 - o]);
  }
  return to_float(x[o]);
}

// One shift pass's value for the place `o`: into the sum over passes, or,
// where the element belongs to the left neighbour, into `send` in f32 (the
// neighbour takes it through `store_pass` itself, see windowed_nmf_slab.cu).
template <typename Addr, typename T>
__device__ __forceinline__ void store_at(float* acc, T* out, float* send, int64_t o, float y, int first, int last,
                                         float scale) {
  if constexpr (Addr::kHalo) {
    if (o < 0) {
      send[-1 - o] = y;
      return;
    }
  }
  store_pass(acc, out, o, y, first, last, scale);
}

// Eight consecutive values as f32: 32 bytes of f32 or 16 of bf16, in one or
// two 16-byte accesses (the caller keeps `p` 16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&r)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w; r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&r)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    r[2 * i] = f.x;
    r[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&r)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(r[0], r[1], r[2], r[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(r[4], r[5], r[6], r[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&r)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(r[2 * i], r[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// store_pass for the 8 channels of a row at `o`, in 16-byte accesses: the
// same roundings, element by element.
template <typename T>
__device__ __forceinline__ void store_pass8(float* acc, T* out, int64_t o, const float (&y)[8], int first, int last,
                                            float scale) {
  float r[8];
  if (first && last) {
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = __fmul_rn(y[i], scale);
    store8(out + o, r);
    return;
  }
  if (first) {
    store8(acc + o, y);
    return;
  }
  load8(acc + o, r);
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = __fadd_rn(r[i], y[i]);
  if (!last) {
    store8(acc + o, r);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = __fmul_rn(r[i], scale);
  store8(out + o, r);
}

// The register-resident solve's thread group for head_dim kD and patch kP:
// kWarps warps hold one P3 x kD matrix, kRows rows of kD channels a thread
// (row q = lane + kThreads * k).  Blocks have 128 threads, so a block holds
// kGroups matrices: (8, 8) is one matrix of 4 warps x 4 rows, (8, 4) four
// matrices of 1 warp x 2 rows.
template <int kD, int kP>
struct Group {
  static constexpr int kP3 = kP * kP * kP;
  static constexpr int kWarps = kP3 >= 512 ? 4 : 1;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = kP3 / kThreads;
  static constexpr int kBlock = 128;
  static constexpr int kGroups = kBlock / kThreads;
  static_assert(kD == 8 && kP3 % kThreads == 0 && kRows >= 1, "the register solve covers head_dim 8 and patch 4 or 8");
};

// The sums of v[0..8] (eight column sums and one scalar) over a group of
// kWarps warps, returned to every thread of the group in v.  Within a warp a
// reduce-scatter (lane 4i holds sum i) takes 9 shuffles where eight
// butterflies would take 40; the warps meet in `red` ([2][kWarps][9] floats
// per group, alternated by `phase` so that one barrier a call suffices) and
// every thread adds the warps' sums in the same order.
template <int kWarps>
__device__ __forceinline__ void group_sum9(float (&v)[9], float* red, int phase) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) % kWarps;
  float a[4];
  {
    const bool hi = lane & 16;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float send = hi ? v[j] : v[j + 4], keep = hi ? v[j + 4] : v[j];
      a[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
  }
  {
    const bool hi = lane & 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float send = hi ? a[j] : a[j + 2], keep = hi ? a[j + 2] : a[j];
      a[j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
  }
  {
    const bool hi = lane & 4;
    const float send = hi ? a[0] : a[1], keep = hi ? a[1] : a[0];
    a[0] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  a[0] += __shfl_xor_sync(0xffffffffu, a[0], 2);
  a[0] += __shfl_xor_sync(0xffffffffu, a[0], 1);
  float s = v[8];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  float* mine = red + (phase * kWarps + warp) * 9;
  if ((lane & 3) == 0) mine[((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1)] = a[0];
  if (lane == 0) mine[8] = s;
  if (kWarps == 1) {
    __syncwarp();
  } else {
    __syncthreads();  // a block of one group
  }
  const float* all = red + phase * kWarps * 9;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float t = all[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += all[w * 9 + i];
    v[i] = t;
  }
}

// The forward solve of one matrix, held in registers by a thread group
// (Group<kD, kP>): stage the matrix with 16-byte loads of a row's kD
// channels, run `num_iters` rank-1 HALS or MU updates from u0 and v0.  Every
// thread ends with all of u and the rows X[k], v[k] of its own rows
// q = lane + kThreads * k.  X v reduces across the group (group_sum9, one
// barrier an iteration); X^T u needs no reduction.  Every product and sum
// is an explicit fmaf / add, so the solve gives the same bits wherever it
// is inlined (K1's factors pass, K5's slab pass).
template <typename T, typename Addr, int kD, int kP>
__device__ __forceinline__ void rank1_group_solve(const Addr& win, const T* __restrict__ x,
                                                  const T* __restrict__ halo, const float* __restrict__ u0,
                                                  const float* __restrict__ v0, int mu, int num_iters, float eps,
                                                  float* red, int lane_g, float (&u)[kD],
                                                  float (&v)[Group<kD, kP>::kRows],
                                                  float (&X)[Group<kD, kP>::kRows][kD]) {
  using G = Group<kD, kP>;
#pragma unroll
  for (int k = 0; k < G::kRows; ++k) {
    const int q = lane_g + G::kThreads * k;
    const int64_t o = win.row_offset(q);
    if (Addr::kHalo && o < 0) {
      load8(halo + (-1 - o), X[k]);
    } else {
      load8(x + o, X[k]);
    }
    v[k] = v0[q];
  }
#pragma unroll
  for (int di = 0; di < kD; ++di) u[di] = u0[di];

  for (int it = 0; it < num_iters; ++it) {
    // u <- HALS: relu((X v + eps) / (v^T v + eps));  MU: u (X v + eps) / (u v^T v + eps)
    float s[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) s[i] = 0.f;
#pragma unroll
    for (int k = 0; k < G::kRows; ++k) {
#pragma unroll
      for (int di = 0; di < kD; ++di) s[di] = fmaf(X[k][di], v[k], s[di]);
      s[8] = fmaf(v[k], v[k], s[8]);
    }
    group_sum9<G::kWarps>(s, red, it & 1);
    // Every thread updates all of u, so HALS's shared denominators are one
    // reciprocal each (a product by 1/b is within an ulp of a / b).
    const float bu = s[8], ru = 1.f / (bu + eps);
    float bv = 0.f;
#pragma unroll
    for (int di = 0; di < kD; ++di) {
      const float uo = u[di], a = s[di];
      u[di] = mu ? fmaf(uo, a, eps) / fmaf(uo, bu, eps) : fmaxf((a + eps) * ru, 0.f);
      bv = fmaf(u[di], u[di], bv);
    }
    // v <- HALS: relu((X^T u + eps) / (u^T u + eps));  MU: v (X^T u + eps) / (v u^T u + eps)
    const float rv = 1.f / (bv + eps);
#pragma unroll
    for (int k = 0; k < G::kRows; ++k) {
      float av = 0.f;
#pragma unroll
      for (int di = 0; di < kD; ++di) av = fmaf(X[k][di], u[di], av);
      const float vo = v[k];
      v[k] = mu ? fmaf(vo, av, eps) / fmaf(vo, bv, eps) : fmaxf((av + eps) * rv, 0.f);
    }
  }
}

// sum_q M[q][di] * w[q] for the matrix M [P3][ld] in shared memory, returned
// to the threads tid < d (thread di gets column di; the others get 0).
// `part` holds kThreads floats, kThreads being the block's size and at least
// d; the call has one barrier inside, and the caller puts another between two
// calls, which reuse `part`.
template <int kThreads>
__device__ __forceinline__ float column_dot(const float* M, const float* w, float* part, int P3, int d, int ld) {
  const int tid = threadIdx.x;
  const int nch = kThreads / d;  // thread = (chunk, di)
  if (tid < nch * d) {
    const int di = tid % d, ch = tid / d;
    float s = 0.f;
    for (int q = ch; q < P3; q += nch) s += M[q * ld + di] * w[q];
    part[tid] = s;
  }
  __syncthreads();
  float a = 0.f;
  if (tid < d) {
    for (int k = 0; k < nch; ++k) a += part[k * d + tid];
  }
  return a;
}

// Shared-memory floats of one forward block of `threads` threads.
inline size_t rank1_fwd_smem_floats(int P3, int d, int threads) {
  return static_cast<size_t>(P3) * (d + 1) + P3 + d + threads + 33;
}

// The forward solve of one matrix of any size by a whole block in shared
// memory: stage the P3 x d matrix X, run `num_iters` rank-1 HALS or MU
// updates from u0 and v0.  Returns with u (d) and v (P3) in `smem` at
// fwd_smem_u / fwd_smem_v and a barrier behind them.  `smem` holds
// rank1_fwd_smem_floats(...) floats.
__device__ __forceinline__ float* fwd_smem_v(float* smem, int P3, int d) { return smem + P3 * (d + 1); }
__device__ __forceinline__ float* fwd_smem_u(float* smem, int P3, int d) { return fwd_smem_v(smem, P3, d) + P3; }

template <typename T, typename Addr, int kThreads>
__device__ __forceinline__ void rank1_smem_solve(const Addr& win, const T* __restrict__ x, const T* __restrict__ halo,
                                                 const float* __restrict__ u0, const float* __restrict__ v0, int mu,
                                                 int num_iters, float eps, float* smem) {
  const int d = win.d, P3 = win.P3;
  const int ld = d + 1;           // padded row: conflict-free column reads
  float* X = smem;                // [P3][ld]
  float* v = X + P3 * ld;         // [P3]
  float* u = v + P3;              // [d]
  float* part = u + d;            // [kThreads]
  float* red = part + kThreads;   // [33]

  const int tid = threadIdx.x;
  const int n_elem = P3 * d;

  for (int e = tid; e < n_elem; e += kThreads) {
    X[(e / d) * ld + e % d] = load_at<Addr>(x, halo, win.offset(e));
  }
  float bu_local = 0.f;
  for (int q = tid; q < P3; q += kThreads) {
    v[q] = v0[q];
    bu_local = fmaf(v0[q], v0[q], bu_local);
  }
  if (tid < d) u[tid] = u0[tid];
  float bu = block_sum(bu_local, red);  // v^T v; ends with a barrier

  for (int it = 0; it < num_iters; ++it) {
    // u <- HALS: relu((X v + eps) / (v^T v + eps));  MU: u (X v + eps) / (u v^T v + eps)
    const float a = column_dot<kThreads>(X, v, part, P3, d, ld);
    if (tid < d) {
      const float uo = u[tid];
      u[tid] = mu ? fmaf(uo, a, eps) / fmaf(uo, bu, eps) : fmaxf((a + eps) / (bu + eps), 0.f);
    }
    __syncthreads();
    // v <- HALS: relu((X^T u + eps) / (u^T u + eps));  MU: v (X^T u + eps) / (v u^T u + eps)
    float bv = 0.f;
    for (int di = 0; di < d; ++di) bv = fmaf(u[di], u[di], bv);
    float vv_local = 0.f;
    for (int q = tid; q < P3; q += kThreads) {
      float av = 0.f;
      for (int di = 0; di < d; ++di) av = fmaf(X[q * ld + di], u[di], av);
      const float vo = v[q];
      const float vn = mu ? fmaf(vo, av, eps) / fmaf(vo, bv, eps) : fmaxf((av + eps) / (bv + eps), 0.f);
      v[q] = vn;
      vv_local = fmaf(vn, vn, vv_local);
    }
    bu = block_sum(vv_local, red);  // next iteration's v^T v; barrier
  }
}

}  // namespace ftt
