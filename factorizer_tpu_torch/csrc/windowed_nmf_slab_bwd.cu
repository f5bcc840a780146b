// K5, backward: one shift pass of dx for a cotangent g on one slab of a
// volume that is cut along its first spatial axis over a ring of devices.
//
// Replaces `_local_backward` (factorizer_tpu/ops/pallas/windowed_sharded.py:
// 90) under the `custom_vjp` of `windowed_nmf_multi_spatial` (:139-166),
// which pads x and g with the left neighbour's rows and runs K1's backward
// Pallas pass (`_shift_bwd_pass_fn`, windowed_nmf_kernel.py:580 ->
// `pallas_call` :591) on the padded slabs, then routes the first s1 rows of
// dx back to the left neighbour.
//
// This is K1's backward block (`rank1_nmf_bwd_block`: the solve rerun in
// shared memory, the reverse sweep written out) under the slab addressing of
// windowed_nmf.cuh: an element of the first window row that lies in the left
// neighbour is read from `x_halo` and `g_halo` (B, s1, S2, S3, C), and its dx
// goes to `send` in f32.  The slab's own last s1 rows of dx arrive from the
// right neighbour and go through `ftt_windowed_nmf_slab_tail`
// (windowed_nmf_slab.cu), so that the sum over passes sees every element once.
//
// What bounds it on the H100: f32 arithmetic, narrowly, as K1's backward (66
// flops per element and shift against 12 bytes in f32); the halos and the
// send buffer add s1 / L of the bytes.  The design is K1's: nothing but x is
// kept between forward and backward, the routed rows are f32, and (d, p) =
// (8, 8) and (8, 4) run K1's register-resident group (`rank1_group_bwd`)
// under the slab addressing, so the slabs give K1's bits.
#include "rank1_nmf_bwd.cuh"

namespace {

constexpr int kThreads = ftt::kWindowThreads;

// Any other size: one block per matrix, in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
windowed_nmf_slab_shift_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ x_halo,
                                   const T* __restrict__ g_halo, float* __restrict__ acc, T* __restrict__ out,
                                   float* __restrict__ send, const float* __restrict__ u0,
                                   const float* __restrict__ v0, int L, int S2, int S3, int C, int d_rt, int p_rt,
                                   int sh1, int sh2, int sh3, int mu, int num_iters, int grad_steps, float eps,
                                   int first, int last, float scale) {
  using Slab = ftt::Window<0, 0, true>;
  const Slab win(d_rt, p_rt, L, S2, S3, C, sh1, sh2, sh3);
  extern __shared__ float smem[];
  ftt::rank1_nmf_bwd_block<T, Slab, kThreads>(win, x, g, x_halo, g_halo, acc, out, send, u0, v0, mu, num_iters,
                                              grad_steps, eps, first, last, scale, smem);
}

template <typename T, int kD, int kP>
__global__ void __launch_bounds__(ftt::Group<kD, kP>::kBlock)
windowed_nmf_slab_shift_bwd_group_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                         const T* __restrict__ x_halo, const T* __restrict__ g_halo,
                                         float* __restrict__ acc, T* __restrict__ out, float* __restrict__ send,
                                         const float* __restrict__ u0, const float* __restrict__ v0, int L, int S2,
                                         int S3, int C, int sh1, int sh2, int sh3, int mu, int num_iters,
                                         int grad_steps, float eps, int first, int last, float scale, int64_t n_mats) {
  using G = ftt::Group<kD, kP>;
  using Slab = ftt::Window<kD, kP, true>;
  extern __shared__ float smem[];
  const int group = threadIdx.x / G::kThreads, lane_g = threadIdx.x % G::kThreads;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * G::kGroups + group;
  if (m >= n_mats) return;  // a whole group leaves together
  const Slab win(kD, kP, L, S2, S3, C, sh1, sh2, sh3, m);
  float* sm = smem + group * ftt::rank1_group_bwd_smem_floats(G::kP3, kD, num_iters, G::kWarps);
  ftt::rank1_group_bwd<T, Slab, kD, kP>(win, x, g, x_halo, g_halo, acc, out, send, u0, v0, mu, num_iters,
                                        grad_steps, eps, first, last, scale, sm, lane_g);
}

template <typename T, int kD, int kP>
cudaError_t launch_group(const void* x, const void* g, const void* x_halo, const void* g_halo, void* acc, void* out,
                         void* send, const float* u0, const float* v0, int64_t n_mats, int L, int S2, int S3, int C,
                         int sh1, int sh2, int sh3, int mu, int num_iters, int grad_steps, float eps, int first,
                         int last, float scale, cudaStream_t stream) {
  using G = ftt::Group<kD, kP>;
  const size_t smem = sizeof(float) * G::kGroups * ftt::rank1_group_bwd_smem_floats(G::kP3, kD, num_iters, G::kWarps);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = windowed_nmf_slab_shift_bwd_group_kernel<T, kD, kP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>((n_mats + G::kGroups - 1) / G::kGroups), G::kBlock, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(x_halo),
      static_cast<const T*>(g_halo), static_cast<float*>(acc), static_cast<T*>(out), static_cast<float*>(send), u0,
      v0, L, S2, S3, C, sh1, sh2, sh3, mu, num_iters, grad_steps, eps, first, last, scale, n_mats);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const void* x_halo, const void* g_halo, void* acc, void* out,
                   void* send, const float* u0, const float* v0, int B, int L, int S2, int S3, int C, int d, int p,
                   int sh1, int sh2, int sh3, int mu, int num_iters, int grad_steps, float eps, int first, int last,
                   float scale, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(B) * (L / p) * (S2 / p) * (S3 / p) * (C / d);
  if (d == 8 && p == 8) {
    return launch_group<T, 8, 8>(x, g, x_halo, g_halo, acc, out, send, u0, v0, blocks, L, S2, S3, C, sh1, sh2, sh3,
                                 mu, num_iters, grad_steps, eps, first, last, scale, stream);
  }
  if (d == 8 && p == 4) {
    return launch_group<T, 8, 4>(x, g, x_halo, g_halo, acc, out, send, u0, v0, blocks, L, S2, S3, C, sh1, sh2, sh3,
                                 mu, num_iters, grad_steps, eps, first, last, scale, stream);
  }
  const size_t smem = sizeof(float) * ftt::rank1_bwd_smem_floats(p * p * p, d, num_iters, kThreads);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = windowed_nmf_slab_shift_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(x_halo),
      static_cast<const T*>(g_halo), static_cast<float*>(acc), static_cast<T*>(out), static_cast<float*>(send), u0,
      v0, L, S2, S3, C, d, p, sh1, sh2, sh3, mu, num_iters, grad_steps, eps, first, last, scale);
  return cudaGetLastError();
}

}  // namespace

// One shift pass of the backward on one slab.  x, g, out (dx): (B, L, S2,
// S3, C) contiguous, of `dtype`; acc: the same shape in f32 (unused when
// first && last); x_halo, g_halo: (B, sh1, S2, S3, C) of `dtype`, send: the
// same shape in f32 (all three unused when sh1 == 0); u0: (d,) f32; v0:
// (p^3,) f32.  Shifts are in [0, p); grad_steps in [1, num_iters] is the
// number of trailing iterations differentiated.  Writes the rows
// [0, L - sh1) of the pass and `send`.
extern "C" int ftt_windowed_nmf_slab_shift_bwd(const void* x, const void* g, const void* x_halo, const void* g_halo,
                                               void* acc, void* out, void* send, const void* u0, const void* v0,
                                               int dtype, int B, int L, int S2, int S3, int C, int d, int p, int sh1,
                                               int sh2, int sh3, int mu, int num_iters, int grad_steps, float eps,
                                               int first, int last, float scale, void* stream) {
  if (d < 1 || d > kThreads || C % d || L % p || S2 % p || S3 % p || sh1 < 0 || sh1 >= p || num_iters < 1 ||
      grad_steps < 1 || grad_steps > num_iters ||
      (sh1 > 0 && (x_halo == nullptr || g_halo == nullptr || send == nullptr))) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto fu0 = static_cast<const float*>(u0);
  auto fv0 = static_cast<const float*>(v0);
  cudaError_t err;
  if (dtype == ftt::kFloat32) {
    err = launch<float>(x, g, x_halo, g_halo, acc, out, send, fu0, fv0, B, L, S2, S3, C, d, p, sh1, sh2, sh3, mu,
                        num_iters, grad_steps, eps, first, last, scale, s);
  } else if (dtype == ftt::kBFloat16) {
    err = launch<__nv_bfloat16>(x, g, x_halo, g_halo, acc, out, send, fu0, fv0, B, L, S2, S3, C, d, p, sh1, sh2, sh3,
                                mu, num_iters, grad_steps, eps, first, last, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
