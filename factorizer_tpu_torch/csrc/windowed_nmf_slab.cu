// K5, forward: one shift pass of the windowed rank-1 NMF on one slab of a
// volume that is cut along its first spatial axis over a ring of devices.
//
// Replaces `windowed_nmf_multi_spatial` (factorizer_tpu/ops/pallas/
// windowed_sharded.py:112), whose `_local_forward` (:66) pads each slab in
// front with the left neighbour's last p rows (`_pad12_halo` :49, a
// `ppermute`), wraps dims 2 and 3 by a padded copy, runs K1's Pallas pass
// (`_shift_pass_fn`, windowed_nmf_kernel.py:502 -> `pallas_call` :521) on the
// padded slab, rolls the result back along dim 2 and sends the first s1 rows
// of it back to the left neighbour (`_roll_back_dim1` :57).  The transport
// stays outside the kernel there and here (torch.distributed).
//
// A slab holds L = S1 / n rows, a multiple of the patch.  For the shift
// (s1, s2, s3) the first window row of the slab covers the rows [-s1, p - s1):
// its elements with a negative row lie in the left neighbour.  This kernel is
// K1's (the same solve: `rank1_group_solve`, or `rank1_smem_solve` at sizes
// other than the bundles'), and the one thing it changes is where such an
// element is:
//   * it is read from `halo` (B, s1, S2, S3, C), the left neighbour's last s1
//     rows (only s1 < p rows are ever read, so s1 rows move, not p);
//   * the pass's value for it is written to `send` (B, s1, S2, S3, C) in f32,
//     not into the local output;
//   * the slab's own last s1 rows are written by no block of this launch:
//     they are the right neighbour's `send`, and `slab_tail_kernel` takes
//     them through the same first / middle / last step (`store_pass`), so
//     that every output element is visited exactly once per pass.
// Dims 2 and 3 wrap in place, as in K1.  With s1 = 0 nothing is exchanged
// and the launch equals K1's on the slab.
//
// What bounds it on the H100: memory, as K1: per pass the slab read once and
// written once (plus the f32 scratch between passes); the halo and the send
// buffer add s1 / L of that.  What the design does about it: K1's reads (no
// roll, fold or padded copy exists; a row's channels in 16-byte accesses) and
// K1's solve; the sum over passes stays one launch per shift into an f32
// scratch, unlike K1's factors-then-reconstruct passes.  The routed rows are
// f32, each product is rounded by __fmul_rn before the pass sum takes it (so
// no FMA contracts the two) and store_pass8 rounds each sum explicitly, as
// K1's reconstruct pass does, so the sum over passes equals K1's on the whole
// volume bit for bit, in bf16 too.
#include "windowed_nmf.cuh"

namespace {

constexpr int kThreads = ftt::kWindowThreads;

// At the compile-time sizes: K1's register-resident solve, one thread group
// per matrix (Group<kD, kP>), then every element of u v^T through store_at.
template <typename T, int kD, int kP>
__global__ void __launch_bounds__(ftt::Group<kD, kP>::kBlock)
windowed_nmf_slab_shift_kernel(const T* __restrict__ x, const T* __restrict__ halo, float* __restrict__ acc,
                               T* __restrict__ out, float* __restrict__ send, const float* __restrict__ u0,
                               const float* __restrict__ v0, int L, int S2, int S3, int C, int sh1, int sh2, int sh3,
                               int64_t n_mats, int mu, int num_iters, float eps, int first, int last, float scale) {
  using G = ftt::Group<kD, kP>;
  using Slab = ftt::Window<kD, kP, true>;
  __shared__ float red[G::kGroups][2 * G::kWarps * 9];
  const int group = threadIdx.x / G::kThreads, lane_g = threadIdx.x % G::kThreads;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * G::kGroups + group;
  if (m >= n_mats) return;  // a whole group leaves together
  const Slab win(kD, kP, L, S2, S3, C, sh1, sh2, sh3, m);
  float u[kD], v[G::kRows], X[G::kRows][kD];
  ftt::rank1_group_solve<T, Slab, kD, kP>(win, x, halo, u0, v0, mu, num_iters, eps, red[group], lane_g, u, v, X);
#pragma unroll
  for (int k = 0; k < G::kRows; ++k) {  // a row's 8 channels in 16-byte accesses
    const int64_t o = win.row_offset(lane_g + G::kThreads * k);
    float y[kD];
#pragma unroll
    for (int di = 0; di < kD; ++di) y[di] = __fmul_rn(u[di], v[k]);
    if (o < 0) {
      ftt::store8(send + (-1 - o), y);
    } else {
      ftt::store_pass8(acc, out, o, y, first, last, scale);
    }
  }
}

// At any other size: K1's shared-memory solve by a 256-thread block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
windowed_nmf_slab_shift_smem_kernel(const T* __restrict__ x, const T* __restrict__ halo, float* __restrict__ acc,
                                    T* __restrict__ out, float* __restrict__ send, const float* __restrict__ u0,
                                    const float* __restrict__ v0, int L, int S2, int S3, int C, int d, int p, int sh1,
                                    int sh2, int sh3, int mu, int num_iters, float eps, int first, int last,
                                    float scale) {
  using Slab = ftt::Window<0, 0, true>;
  const Slab win(d, p, L, S2, S3, C, sh1, sh2, sh3);
  extern __shared__ float smem[];
  ftt::rank1_smem_solve<T, Slab, kThreads>(win, x, halo, u0, v0, mu, num_iters, eps, smem);
  const int P3 = win.P3;
  const float* us = ftt::fwd_smem_u(smem, P3, d);
  const float* vs = ftt::fwd_smem_v(smem, P3, d);
  for (int e = threadIdx.x; e < P3 * d; e += kThreads) {
    ftt::store_at<Slab>(acc, out, send, win.offset(e), __fmul_rn(us[e % d], vs[e / d]), first, last, scale);
  }
}

// The rows that arrived from the right neighbour: `recv` (B, s1, R) in f32,
// R = S2 * S3 * C, is one pass's value for the slab's rows [L - s1, L).
template <typename T>
__global__ void __launch_bounds__(kThreads)
slab_tail_kernel(const float* __restrict__ recv, float* __restrict__ acc, T* __restrict__ out, int64_t n, int64_t L,
                 int64_t R, int64_t sh1, int first, int last, float scale) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    const int64_t b = i / (sh1 * R), rem = i % (sh1 * R);
    ftt::store_pass(acc, out, (b * L + L - sh1) * R + rem, recv[i], first, last, scale);
  }
}

template <typename T, int kD, int kP>
cudaError_t launch_group(const T* x, const T* halo, float* acc, T* out, float* send, const float* u0, const float* v0,
                         int B, int L, int S2, int S3, int C, int sh1, int sh2, int sh3, int mu, int num_iters,
                         float eps, int first, int last, float scale, cudaStream_t stream) {
  using G = ftt::Group<kD, kP>;
  const int64_t n_mats = static_cast<int64_t>(B) * (L / kP) * (S2 / kP) * (S3 / kP) * (C / kD);
  windowed_nmf_slab_shift_kernel<T, kD, kP><<<static_cast<unsigned>((n_mats + G::kGroups - 1) / G::kGroups), G::kBlock,
                                              0, stream>>>(x, halo, acc, out, send, u0, v0, L, S2, S3, C, sh1, sh2,
                                                           sh3, n_mats, mu, num_iters, eps, first, last, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x_, const void* halo_, void* acc_, void* out_, void* send_, const float* u0,
                   const float* v0, int B, int L, int S2, int S3, int C, int d, int p, int sh1, int sh2, int sh3,
                   int mu, int num_iters, float eps, int first, int last, float scale, cudaStream_t stream) {
  auto x = static_cast<const T*>(x_);
  auto halo = static_cast<const T*>(halo_);
  auto acc = static_cast<float*>(acc_);
  auto out = static_cast<T*>(out_);
  auto send = static_cast<float*>(send_);
  // The bundles' sizes take K1's register-resident solve.
  if (d == 8 && p == 8) {
    return launch_group<T, 8, 8>(x, halo, acc, out, send, u0, v0, B, L, S2, S3, C, sh1, sh2, sh3, mu, num_iters, eps,
                                 first, last, scale, stream);
  }
  if (d == 8 && p == 4) {
    return launch_group<T, 8, 4>(x, halo, acc, out, send, u0, v0, B, L, S2, S3, C, sh1, sh2, sh3, mu, num_iters, eps,
                                 first, last, scale, stream);
  }
  const size_t smem = sizeof(float) * ftt::rank1_fwd_smem_floats(p * p * p, d, kThreads);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = windowed_nmf_slab_shift_smem_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = static_cast<int64_t>(B) * (L / p) * (S2 / p) * (S3 / p) * (C / d);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(x, halo, acc, out, send, u0, v0, L, S2, S3, C, d,
                                                                   p, sh1, sh2, sh3, mu, num_iters, eps, first, last,
                                                                   scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tail(const void* recv, void* acc, void* out, int64_t B, int64_t L, int64_t R, int64_t sh1,
                        int first, int last, float scale, cudaStream_t stream) {
  const int64_t n = B * sh1 * R;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  slab_tail_kernel<T><<<static_cast<unsigned>(blocks < 65535 * 16 ? blocks : 65535 * 16), kThreads, 0, stream>>>(
      static_cast<const float*>(recv), static_cast<float*>(acc), static_cast<T*>(out), n, L, R, sh1, first, last,
      scale);
  return cudaGetLastError();
}

}  // namespace

// One shift pass on one slab.  x, out: (B, L, S2, S3, C) contiguous, of
// `dtype`; acc: the same shape in f32 (unused when first && last); halo:
// (B, sh1, S2, S3, C) of `dtype`, send: the same shape in f32 (both unused
// when sh1 == 0); u0: (d,) f32; v0: (p^3,) f32.  Shifts are in [0, p).
// Writes the rows [0, L - sh1) of the pass and `send`.
extern "C" int ftt_windowed_nmf_slab_shift(const void* x, const void* halo, void* acc, void* out, void* send,
                                           const void* u0, const void* v0, int dtype, int B, int L, int S2, int S3,
                                           int C, int d, int p, int sh1, int sh2, int sh3, int mu, int num_iters,
                                           float eps, int first, int last, float scale, void* stream) {
  if (d < 1 || d > kThreads || C % d || L % p || S2 % p || S3 % p || sh1 < 0 || sh1 >= p ||
      (sh1 > 0 && (halo == nullptr || send == nullptr))) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto fu0 = static_cast<const float*>(u0);
  auto fv0 = static_cast<const float*>(v0);
  cudaError_t err;
  if (dtype == ftt::kFloat32) {
    err = launch<float>(x, halo, acc, out, send, fu0, fv0, B, L, S2, S3, C, d, p, sh1, sh2, sh3, mu, num_iters, eps,
                        first, last, scale, s);
  } else if (dtype == ftt::kBFloat16) {
    err = launch<__nv_bfloat16>(x, halo, acc, out, send, fu0, fv0, B, L, S2, S3, C, d, p, sh1, sh2, sh3, mu,
                                num_iters, eps, first, last, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The slab's last sh1 rows of one pass, forward or backward: recv
// (B, sh1, R) f32 with R = S2 * S3 * C; acc (B, L, R) f32 and out (B, L, R)
// of `dtype` as in the pass itself, with the same first / last / scale.
extern "C" int ftt_windowed_nmf_slab_tail(const void* recv, void* acc, void* out, int dtype, int B, int L,
                                          long long R, int sh1, int first, int last, float scale, void* stream) {
  if (B < 1 || sh1 < 1 || sh1 > L || R < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == ftt::kFloat32) {
    err = launch_tail<float>(recv, acc, out, B, L, R, sh1, first, last, scale, s);
  } else if (dtype == ftt::kBFloat16) {
    err = launch_tail<__nv_bfloat16>(recv, acc, out, B, L, R, sh1, first, last, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
