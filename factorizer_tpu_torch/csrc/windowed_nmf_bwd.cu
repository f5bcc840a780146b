// K1, backward: dx of the shifted-window rank-1 NMF for a cotangent g.
//
// Replaces the Pallas kernels `_shift_bwd_kernel` (factorizer_tpu/ops/pallas/
// windowed_nmf_kernel.py:411, launched per shift at :591) and, with the one
// zero shift, `_bwd_kernel` (:249, launched at :790).  Those take `jax.vjp`
// over the unrolled solve inside the kernel; here the reverse sweep is
// written out (rank1_nmf_bwd.cuh, which K4's rank-1 backward shares).  Per
// (sample, window, head) block, X is the p^3 x d matrix of the rolled volume
// and G the cotangent at the same wrapped coordinates (the adjoint of the
// output's inverse roll is the same roll).
//
// What bounds it on the H100: f32 arithmetic, narrowly.  Per element and
// shift it does 4 flops per forward iteration, 2 for the product and the
// shift sum, 4 for the seed and 8 per differentiated iteration (66 at
// T = g = 5) against 12 bytes in f32 (x and g read, dx written): 0.53 ms of
// CUDA-core time against 0.48 ms of memory time for the (2,128^3,32) stage
// with 4 shifts.
//
// What the design does about it: nothing is stored in device memory between
// forward and backward but x; each matrix's solve is rerun with every iterate
// kept.  At the bundles' sizes, (d, p) = (8, 8) and (8, 4), the forward's
// thread groups hold the matrix (`rank1_group_bwd`): 4 warps a matrix at
// p = 8, one warp at p = 4 with four matrices to a 128-thread block; X and
// G / dX rows stay in registers, four rows of 8 channels a thread at p = 8,
// read and written in 16-byte accesses; X v, G^T v and X^T abar reduce by the
// forward's shuffle reduce-scatter (`group_sum9`), one barrier a step; only
// the iterates go to shared memory (13 KB a matrix at p = 8, 2 KB at p = 4).
// Other sizes take one 256-thread block per matrix with everything in shared
// memory (`rank1_nmf_bwd_block`, which K4's rank-1 backward also runs).  The
// shifts stay separate launches that add into an f32 scratch in stream
// order: that order is what K5's backward reproduces bit for bit, and the
// scratch sets this design's floor (x and g read once a shift, the f32 sum
// read and written: 60 B an element over four f32 shifts).
#include "rank1_nmf_bwd.cuh"

namespace {

constexpr int kThreads = ftt::kWindowThreads;

// Any other size: one block per matrix, in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
windowed_nmf_shift_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ acc,
                              T* __restrict__ out, const float* __restrict__ u0,
                              const float* __restrict__ v0, int S1, int S2, int S3, int C, int d_rt,
                              int p_rt, int sh1, int sh2, int sh3, int mu, int num_iters,
                              int grad_steps, float eps, int first, int last, float scale) {
  const ftt::Window<0, 0> win(d_rt, p_rt, S1, S2, S3, C, sh1, sh2, sh3);
  extern __shared__ float smem[];
  ftt::rank1_nmf_bwd_block<T, ftt::Window<0, 0>, kThreads>(win, x, g, nullptr, nullptr, acc, out, nullptr, u0, v0,
                                                             mu, num_iters, grad_steps, eps, first, last, scale, smem);
}

// The compile-time sizes: a thread group per matrix (Group<kD, kP>), kGroups to a block.
template <typename T, int kD, int kP>
__global__ void __launch_bounds__(ftt::Group<kD, kP>::kBlock)
windowed_nmf_shift_bwd_group_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ acc,
                                    T* __restrict__ out, const float* __restrict__ u0, const float* __restrict__ v0,
                                    int S1, int S2, int S3, int C, int sh1, int sh2, int sh3, int mu, int num_iters,
                                    int grad_steps, float eps, int first, int last, float scale, int64_t n_mats) {
  using G = ftt::Group<kD, kP>;
  extern __shared__ float smem[];
  const int group = threadIdx.x / G::kThreads, lane_g = threadIdx.x % G::kThreads;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * G::kGroups + group;
  if (m >= n_mats) return;  // a whole group leaves together
  const ftt::Window<kD, kP> win(kD, kP, S1, S2, S3, C, sh1, sh2, sh3, m);
  float* sm = smem + group * ftt::rank1_group_bwd_smem_floats(G::kP3, kD, num_iters, G::kWarps);
  ftt::rank1_group_bwd<T, ftt::Window<kD, kP>, kD, kP>(win, x, g, nullptr, nullptr, acc, out, nullptr, u0, v0, mu,
                                                       num_iters, grad_steps, eps, first, last, scale, sm, lane_g);
}

template <typename T, int kD, int kP>
cudaError_t launch_group(const void* x, const void* g, void* acc, void* out, const float* u0, const float* v0,
                         int64_t n_mats, int S1, int S2, int S3, int C, int sh1, int sh2, int sh3, int mu,
                         int num_iters, int grad_steps, float eps, int first, int last, float scale,
                         cudaStream_t stream) {
  using G = ftt::Group<kD, kP>;
  const size_t smem = sizeof(float) * G::kGroups * ftt::rank1_group_bwd_smem_floats(G::kP3, kD, num_iters, G::kWarps);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = windowed_nmf_shift_bwd_group_kernel<T, kD, kP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>((n_mats + G::kGroups - 1) / G::kGroups), G::kBlock, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<float*>(acc), static_cast<T*>(out), u0, v0,
      S1, S2, S3, C, sh1, sh2, sh3, mu, num_iters, grad_steps, eps, first, last, scale, n_mats);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* g, void* acc, void* out, const float* u0, const float* v0,
                   int B, int S1, int S2, int S3, int C, int d, int p, int sh1, int sh2, int sh3,
                   int mu, int num_iters, int grad_steps, float eps, int first, int last, float scale,
                   cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(B) * (S1 / p) * (S2 / p) * (S3 / p) * (C / d);
  if (d == 8 && p == 8) {
    return launch_group<T, 8, 8>(x, g, acc, out, u0, v0, blocks, S1, S2, S3, C, sh1, sh2, sh3, mu, num_iters,
                                 grad_steps, eps, first, last, scale, stream);
  }
  if (d == 8 && p == 4) {
    return launch_group<T, 8, 4>(x, g, acc, out, u0, v0, blocks, S1, S2, S3, C, sh1, sh2, sh3, mu, num_iters,
                                 grad_steps, eps, first, last, scale, stream);
  }
  const size_t smem = sizeof(float) * ftt::rank1_bwd_smem_floats(p * p * p, d, num_iters, kThreads);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = windowed_nmf_shift_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<float*>(acc),
      static_cast<T*>(out), u0, v0, S1, S2, S3, C, d, p, sh1, sh2, sh3, mu, num_iters, grad_steps,
      eps, first, last, scale);
  return cudaGetLastError();
}

}  // namespace

// One shift pass of the backward.  x, g, out (dx): (B, S1, S2, S3, C)
// contiguous, of `dtype`; acc: the same shape in f32 (unused when first &&
// last); u0: (d,) f32; v0: (p^3,) f32.  Shifts are in [0, p); grad_steps in
// [1, num_iters] is the number of trailing iterations differentiated.
// Returns cudaGetLastError().
extern "C" int ftt_windowed_nmf_shift_bwd(const void* x, const void* g, void* acc, void* out,
                                          const void* u0, const void* v0, int dtype, int B, int S1,
                                          int S2, int S3, int C, int d, int p, int sh1, int sh2,
                                          int sh3, int mu, int num_iters, int grad_steps, float eps,
                                          int first, int last, float scale, void* stream) {
  if (d < 1 || d > kThreads || C % d || S1 % p || S2 % p || S3 % p || num_iters < 1 ||
      grad_steps < 1 || grad_steps > num_iters) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto fu0 = static_cast<const float*>(u0);
  auto fv0 = static_cast<const float*>(v0);
  cudaError_t err;
  if (dtype == ftt::kFloat32) {
    err = launch<float>(x, g, acc, out, fu0, fv0, B, S1, S2, S3, C, d, p, sh1, sh2, sh3, mu,
                        num_iters, grad_steps, eps, first, last, scale, s);
  } else if (dtype == ftt::kBFloat16) {
    err = launch<__nv_bfloat16>(x, g, acc, out, fu0, fv0, B, S1, S2, S3, C, d, p, sh1, sh2, sh3, mu,
                                num_iters, grad_steps, eps, first, last, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
