// K1, forward: shifted-window rank-1 NMF on a channels-last volume.
//
// Replaces the Pallas kernel `_shift_kernel` (factorizer_tpu/ops/pallas/
// windowed_nmf_kernel.py:379), launched per shift by `_shift_pass_fn` (:502)
// under `windowed_nmf_multi` (:652).  For one shift s it computes, for every
// (sample, window, head), the d x p^3 matrix X of the volume rolled by +s,
// runs `num_iters` rank-1 HALS or MU updates from the shared tables u0 (d)
// and v0 (p^3), and writes u v^T back at the un-rolled coordinates.  The
// shifts run as separate launches on one stream that accumulate into an f32
// scratch; the last one scales by 1/n and casts to the output dtype, so the
// sum is deterministic and needs no atomics.
//
// What bounds it on the H100: memory.  The solve is ~10 flops per element
// per iteration on data held in shared memory, while each shift streams the
// volume in (x, plus the f32 scratch after the first shift) and out once:
// 12 bytes per element per f32 shift, about 1.6 GB for the (2,128^3,32)
// stage at 3.35 TB/s, i.e. ~0.5 ms per shift at the roofline.
//
// What the design does about it: one thread block per (sample, window, head)
// reads its matrix straight from the volume at cyclically wrapped
// coordinates, so no rolled copy, fold or unfold is ever materialised, and
// each element is read and written exactly once per shift.  Threads of a
// warp take consecutive channels of consecutive voxels, so a head's d
// channels (32 bytes in f32 at d = 8) are one full sector.  The TPU kernel's
// lane packing, wrap padding and block-diagonal head mask are Mosaic layout
// workarounds and have no counterpart here.
#include "windowed_nmf.cuh"

namespace {

constexpr int kThreads = ftt::kWindowThreads;

template <typename T, int kD, int kP>
__global__ void __launch_bounds__(kThreads)
windowed_nmf_shift_kernel(const T* __restrict__ x, float* __restrict__ acc, T* __restrict__ out,
                          const float* __restrict__ u0, const float* __restrict__ v0,
                          int S1, int S2, int S3, int C, int d_rt, int p_rt, int sh1, int sh2,
                          int sh3, int mu, int num_iters, float eps, int first, int last,
                          float scale) {
  const ftt::Window<kD, kP> win(d_rt, p_rt, S1, S2, S3, C, sh1, sh2, sh3);
  const int d = win.d, P3 = win.P3;
  extern __shared__ float smem[];
  const int ld = d + 1;           // padded row: conflict-free column reads
  float* X = smem;                // [P3][ld]
  float* v = X + P3 * ld;         // [P3]
  float* u = v + P3;              // [d]
  float* part = u + d;            // [kThreads]
  float* red = part + kThreads;   // [33]

  const int tid = threadIdx.x;
  const int n_elem = P3 * d;

  for (int e = tid; e < n_elem; e += kThreads) {
    X[(e / d) * ld + e % d] = ftt::to_float(x[win.offset(e)]);
  }
  float bu_local = 0.f;
  for (int q = tid; q < P3; q += kThreads) {
    v[q] = v0[q];
    bu_local += v0[q] * v0[q];
  }
  if (tid < d) u[tid] = u0[tid];
  float bu = ftt::block_sum(bu_local, red);  // v^T v; ends with a barrier

  for (int it = 0; it < num_iters; ++it) {
    // u <- HALS: relu((X v + eps) / (v^T v + eps));  MU: u (X v + eps) / (u v^T v + eps)
    const float a = ftt::column_dot(X, v, part, P3, d, ld);
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
    bu = ftt::block_sum(vv_local, red);  // next iteration's v^T v; barrier
  }

  for (int e = tid; e < n_elem; e += kThreads) {
    ftt::store_pass(acc, out, win.offset(e), u[e % d] * v[e / d], first, last, scale);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* acc, void* out, const float* u0, const float* v0, int B,
                   int S1, int S2, int S3, int C, int d, int p, int sh1, int sh2, int sh3, int mu,
                   int num_iters, float eps, int first, int last, float scale, cudaStream_t stream) {
  const int P3 = p * p * p;
  const size_t smem = sizeof(float) * (static_cast<size_t>(P3) * (d + 1) + P3 + d + kThreads + 33);
  // The bundle's head_dim 8 and patch 8 get a compile-time instance.
  auto kernel = (d == 8 && p == 8) ? windowed_nmf_shift_kernel<T, 8, 8> : windowed_nmf_shift_kernel<T, 0, 0>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = static_cast<int64_t>(B) * (S1 / p) * (S2 / p) * (S3 / p) * (C / d);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(acc), static_cast<T*>(out), u0, v0, S1, S2,
      S3, C, d, p, sh1, sh2, sh3, mu, num_iters, eps, first, last, scale);
  return cudaGetLastError();
}

}  // namespace

// One shift pass.  x, out: (B, S1, S2, S3, C) contiguous, of `dtype`;
// acc: the same shape in f32 (unused when first && last); u0: (d,) f32;
// v0: (p^3,) f32.  Shifts are in [0, p).  Returns cudaGetLastError().
extern "C" int ftt_windowed_nmf_shift(const void* x, void* acc, void* out, const void* u0,
                                      const void* v0, int dtype, int B, int S1, int S2, int S3,
                                      int C, int d, int p, int sh1, int sh2, int sh3, int mu,
                                      int num_iters, float eps, int first, int last, float scale,
                                      void* stream) {
  if (d < 1 || d > kThreads || C % d || S1 % p || S2 % p || S3 % p) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto fu0 = static_cast<const float*>(u0);
  auto fv0 = static_cast<const float*>(v0);
  cudaError_t err;
  if (dtype == ftt::kFloat32) {
    err = launch<float>(x, acc, out, fu0, fv0, B, S1, S2, S3, C, d, p, sh1, sh2, sh3, mu,
                        num_iters, eps, first, last, scale, s);
  } else if (dtype == ftt::kBFloat16) {
    err = launch<__nv_bfloat16>(x, acc, out, fu0, fv0, B, S1, S2, S3, C, d, p, sh1, sh2, sh3, mu,
                                num_iters, eps, first, last, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ftt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
