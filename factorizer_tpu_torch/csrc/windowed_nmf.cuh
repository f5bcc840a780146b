// What the forward and the backward kernel of K1 share: the block's window
// and where its elements lie in the volume, and the sum over shift passes.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ftt {

constexpr int kWindowThreads = 256;

// The (sample, window, head) of block `blockIdx.x` for one shift pass.
// kD / kP > 0 fix head_dim / patch at compile time, which turns the index
// arithmetic into shifts and masks; 0 takes the runtime d / p.
template <int kD, int kP>
struct Window {
  int d, p, P3, S1, S2, S3, C, c0, o1, o2, o3;
  int64_t b;

  __device__ Window(int d_rt, int p_rt, int S1_, int S2_, int S3_, int C_, int sh1, int sh2, int sh3)
      : d(kD > 0 ? kD : d_rt), p(kP > 0 ? kP : p_rt), S1(S1_), S2(S2_), S3(S3_), C(C_) {
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
    c1 += c1 < 0 ? S1 : 0;
    c2 += c2 < 0 ? S2 : 0;
    c3 += c3 < 0 ? S3 : 0;
    return (((b * S1 + c1) * S2 + c2) * S3 + c3) * C + c0 + di;
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

// sum_q M[q][di] * w[q] for the matrix M [P3][ld] in shared memory, returned
// to the threads tid < d (thread di gets column di; the others get 0).
// `part` holds kWindowThreads floats; the call has one barrier inside, and
// the caller puts another between two calls, which reuse `part`.
__device__ __forceinline__ float column_dot(const float* M, const float* w, float* part, int P3, int d, int ld) {
  const int tid = threadIdx.x;
  const int nch = kWindowThreads / d;  // thread = (chunk, di)
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

}  // namespace ftt
