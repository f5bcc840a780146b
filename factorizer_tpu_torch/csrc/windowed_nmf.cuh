// What the forward and the backward kernels of K1 and of K5 (K1 on a slab of
// a volume cut along S1) share: the block's window and where its elements
// lie, the forward solve, and the sum over shift passes.  The column sum and
// the output pass also serve the flat kernels (nmf_bwd.cu).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ftt {

constexpr int kWindowThreads = 256;

// The (sample, window, head) of block `blockIdx.x` for one shift pass.
// kD / kP > 0 fix head_dim / patch at compile time, which turns the index
// arithmetic into shifts and masks; 0 takes the runtime d / p.
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

  __device__ Window(int d_rt, int p_rt, int S1_, int S2_, int S3_, int C_, int sh1, int sh2, int sh3)
      : d(kD > 0 ? kD : d_rt), p(kP > 0 ? kP : p_rt), S1(S1_), S2(S2_), S3(S3_), C(C_), h1(sh1) {
    P3 = p * p * p;
    const int heads = C / d;
    const int G1 = S1 / p, G2 = S2 / p, G3 = S3 / p;
    int64_t blk = blockIdx.x;
    c0 = static_cast<int>(blk % heads) * d; blk /= heads;
    o3 = static_cast<int>(blk % G3) * p - sh3; blk /= G3;
    o2 = static_cast<int>(blk % G2) * p - sh2; blk /= G2;
    o1 = static_cast<int>(blk % G1) * p - sh1; blk /= G1;
    b = blk;
  }

  // Element e of the window is (q, di) with di fastest; q = (a1, a2, a3),
  // a1-major.  The rolled coordinate i maps to the volume coordinate
  // (i - s) mod S for both the read and the write; i - s > -p >= -S, so one
  // conditional add wraps it.
  __device__ int64_t offset(int e) const {
    const int q = e / d, di = e % d;
    const int a1 = q / (p * p), a2 = (q / p) % p, a3 = q % p;
    int c1 = o1 + a1, c2 = o2 + a2, c3 = o3 + a3;
    c2 += c2 < 0 ? S2 : 0;
    c3 += c3 < 0 ? S3 : 0;
    if (kSlab) {
      if (c1 < 0) return -1 - ((((b * h1 + c1 + h1) * S2 + c2) * S3 + c3) * C + c0 + di);
    } else {
      c1 += c1 < 0 ? S1 : 0;
    }
    return (((b * S1 + c1) * S2 + c2) * S3 + c3) * C + c0 + di;
  }

  // Element e as (row q, column di) of the block's matrix, and where it lies.
  __device__ int64_t locate(int e, int& q, int& di) const {
    q = e / d;
    di = e % d;
    return offset(e);
  }
};

// One shift pass's value `y` for the element at `o`: the first pass starts
// the f32 scratch `acc`, the middle ones add to it, the last scales the sum
// and casts it into `out`.  The passes are separate launches on one stream,
// so the sum has a fixed order and needs no atomics.
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

// One shift pass of the forward on one block's window: stage the P3 x d
// matrix X, run `num_iters` rank-1 HALS or MU updates from u0 and v0, and
// hand u v^T to `store_at`.  `halo` and `send` are read and written only
// under a slab addressing.  `smem` holds rank1_fwd_smem_floats(...) floats.
template <typename T, typename Addr, int kThreads>
__device__ __forceinline__ void rank1_nmf_fwd_block(
    const Addr& win, const T* __restrict__ x, const T* __restrict__ halo, float* __restrict__ acc,
    T* __restrict__ out, float* __restrict__ send, const float* __restrict__ u0, const float* __restrict__ v0,
    int mu, int num_iters, float eps, int first, int last, float scale, float* smem) {
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
    bu_local += v0[q] * v0[q];
  }
  if (tid < d) u[tid] = u0[tid];
  float bu = block_sum(bu_local, red);  // v^T v; ends with a barrier

  for (int it = 0; it < num_iters; ++it) {
    // u <- HALS: relu((X v + eps) / (v^T v + eps));  MU: u (X v + eps) / (u v^T v + eps)
    const float a = column_dot<kThreads>(X, v, part, P3, d, ld);
    if (tid < d) {
      const float uo = u[tid];
      u[tid] = mu ? (uo * a + eps) / (uo * bu + eps) : fmaxf((a + eps) / (bu + eps), 0.f);
    }
    __syncthreads();
    // v <- HALS: relu((X^T u + eps) / (u^T u + eps));  MU: v (X^T u + eps) / (v u^T u + eps)
    float bv = 0.f;
    for (int di = 0; di < d; ++di) bv += u[di] * u[di];
    float vv_local = 0.f;
    for (int q = tid; q < P3; q += kThreads) {
      float av = 0.f;
      for (int di = 0; di < d; ++di) av += X[q * ld + di] * u[di];
      const float vo = v[q];
      const float vn = mu ? (vo * av + eps) / (vo * bv + eps) : fmaxf((av + eps) / (bv + eps), 0.f);
      v[q] = vn;
      vv_local += vn * vn;
    }
    bu = block_sum(vv_local, red);  // next iteration's v^T v; barrier
  }

  for (int e = tid; e < n_elem; e += kThreads) {
    store_at<Addr>(acc, out, send, win.offset(e), u[e % d] * v[e / d], first, last, scale);
  }
}

}  // namespace ftt
