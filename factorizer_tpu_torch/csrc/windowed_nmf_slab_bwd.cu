// K5, backward: dx of the windowed rank-1 NMF for a cotangent g on one slab
// of a volume that is cut along its first spatial axis over a ring of
// devices, one launch per shift pass and one ordered tail.
//
// Replaces `_local_backward` (factorizer_tpu/ops/pallas/windowed_sharded.py:
// 90) under the `custom_vjp` of `windowed_nmf_multi_spatial` (:139-166),
// which pads x and g with the left neighbour's rows and runs K1's backward
// Pallas pass (`_shift_bwd_pass_fn`, windowed_nmf_kernel.py:580 ->
// `pallas_call` :591) on the padded slabs, then routes the first s1 rows of
// dx back to the left neighbour.
//
// Each pass is K1's backward block (`rank1_group_bwd`, or
// `rank1_nmf_bwd_block` at sizes other than the bundles') under the slab
// addressing of windowed_nmf.cuh, H being the largest s1 of the call:
//   * one exchange before the first pass brings the left neighbour's last H
//     rows of x and of g (the halos, in the slab's dtype); a shift of s1
//     reads their last s1 rows;
//   * a pass writes its dx for the slab's rows [0, L - H) through K1's
//     store_pass chain (an f32 scratch; the last pass scales and casts), its
//     values for the rows [L - H, L - s1) into its own f32 edge slot
//     (B, H, S2, S3, C) and those for the left neighbour's last s1 rows into
//     its slot of the send buffer (B, s1, S2, S3, C, f32);
//   * one exchange after the last pass carries every shift's send slots
//     backward along the ring;
//   * `slab_tail_kernel` then writes the slab's last H rows: for each element
//     every shift's value in pass order, from the own edge slot or from what
//     arrived, with the chain's roundings (__fadd_rn, then __fmul_rn by
//     1 / n), so an early pass that routes rows and a later one that does
//     not still sum in K1's order.
// The edge rows are never in the chain, so the order does not depend on which
// pass routes rows; dx equals K1 bwd's on the whole volume bit for bit.
//
// What bounds it on the H100: f32 arithmetic, narrowly, as K1's backward (66
// flops per element and shift against 12 bytes in f32); the halos, the edge
// and send slots and the tail add H / L of the bytes.  The design is K1 bwd's
// (its register-resident block, nothing but x kept between forward and
// backward), with 2 exchanges and n_shifts + 1 launches a mixer.
#include "rank1_nmf_bwd.cuh"

namespace {

constexpr int kThreads = ftt::kWindowThreads;
// Most shifts the ordered tail takes (they travel by value).
constexpr int kMaxTailShifts = 64;

struct TailShifts {
  int n;
  int s1[kMaxTailShifts];
};

// Any other size: one block per matrix, in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
windowed_nmf_slab_shift_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ x_halo,
                                   const T* __restrict__ g_halo, float* __restrict__ acc, T* __restrict__ out,
                                   float* __restrict__ send, float* __restrict__ own, const float* __restrict__ u0,
                                   const float* __restrict__ v0, int L, int S2, int S3, int C, int d_rt, int p_rt,
                                   int H, int sh1, int sh2, int sh3, int mu, int num_iters, int grad_steps, float eps,
                                   int first, int last, float scale) {
  using Slab = ftt::Window<0, 0, true>;
  const Slab win(d_rt, p_rt, L, S2, S3, C, sh1, sh2, sh3, -1, H);
  extern __shared__ float smem[];
  ftt::rank1_nmf_bwd_block<T, Slab, kThreads>(win, x, g, x_halo, g_halo, acc, out, send, own, u0, v0, mu, num_iters,
                                              grad_steps, eps, first, last, scale, smem);
}

template <typename T, int kD, int kP>
__global__ void __launch_bounds__(ftt::Group<kD, kP>::kBlock)
windowed_nmf_slab_shift_bwd_group_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                         const T* __restrict__ x_halo, const T* __restrict__ g_halo,
                                         float* __restrict__ acc, T* __restrict__ out, float* __restrict__ send,
                                         float* __restrict__ own, const float* __restrict__ u0,
                                         const float* __restrict__ v0, int L, int S2, int S3, int C, int H, int sh1,
                                         int sh2, int sh3, int mu, int num_iters, int grad_steps, float eps, int first,
                                         int last, float scale, int64_t n_mats) {
  using G = ftt::Group<kD, kP>;
  using Slab = ftt::Window<kD, kP, true>;
  extern __shared__ float smem[];
  const int group = threadIdx.x / G::kThreads, lane_g = threadIdx.x % G::kThreads;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * G::kGroups + group;
  if (m >= n_mats) return;  // a whole group leaves together
  const Slab win(kD, kP, L, S2, S3, C, sh1, sh2, sh3, m, H);
  float* sm = smem + group * ftt::rank1_group_bwd_smem_floats(G::kP3, kD, num_iters, G::kWarps);
  ftt::rank1_group_bwd<T, Slab, kD, kP>(win, x, g, x_halo, g_halo, acc, out, send, own, u0, v0, mu, num_iters,
                                        grad_steps, eps, first, last, scale, sm, lane_g);
}

// The slab's last H rows, once every pass has run and the routed rows have
// arrived: own (n_shifts, B, H, R) holds each pass's values for the rows
// [L - H, L - s1), recv each shift's s1 rows (B, s1, R) one after the other,
// R = S2 * S3 * C.  Each element sums its passes in order and is scaled.
template <typename T>
__global__ void __launch_bounds__(kThreads)
slab_tail_kernel(const float* __restrict__ own, const float* __restrict__ recv, T* __restrict__ out, int64_t B,
                 int64_t L, int64_t R, int H, TailShifts sh, float scale) {
  const int64_t n = B * H * R;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    const int64_t b = i / (H * R), rest = i % R;
    const int j = static_cast<int>(i / R % H);  // the row, counted from L - H
    float sum = 0.f;
    int64_t before = 0;  // rows of the earlier shifts in recv
    for (int k = 0; k < sh.n; ++k) {
      const int s1 = sh.s1[k];
      const float y = j < H - s1 ? own[k * n + i] : recv[(before + b * s1 + j - (H - s1)) * R + rest];
      sum = k == 0 ? y : __fadd_rn(sum, y);
      before += B * s1;
    }
    out[(b * L + L - H + j) * R + rest] = ftt::from_float<T>(__fmul_rn(sum, scale));
  }
}

template <typename T, int kD, int kP>
cudaError_t launch_group(const void* x, const void* g, const void* x_halo, const void* g_halo, void* acc, void* out,
                         void* send, void* own, const float* u0, const float* v0, int64_t n_mats, int L, int S2,
                         int S3, int C, int H, int sh1, int sh2, int sh3, int mu, int num_iters, int grad_steps,
                         float eps, int first, int last, float scale, cudaStream_t stream) {
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
      static_cast<const T*>(g_halo), static_cast<float*>(acc), static_cast<T*>(out), static_cast<float*>(send),
      static_cast<float*>(own), u0, v0, L, S2, S3, C, H, sh1, sh2, sh3, mu, num_iters, grad_steps, eps, first, last,
      scale, n_mats);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const void* x_halo, const void* g_halo, void* acc, void* out,
                   void* send, void* own, const float* u0, const float* v0, int B, int L, int S2, int S3, int C, int d,
                   int p, int H, int sh1, int sh2, int sh3, int mu, int num_iters, int grad_steps, float eps,
                   int first, int last, float scale, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(B) * (L / p) * (S2 / p) * (S3 / p) * (C / d);
  if (d == 8 && p == 8) {
    return launch_group<T, 8, 8>(x, g, x_halo, g_halo, acc, out, send, own, u0, v0, blocks, L, S2, S3, C, H, sh1,
                                 sh2, sh3, mu, num_iters, grad_steps, eps, first, last, scale, stream);
  }
  if (d == 8 && p == 4) {
    return launch_group<T, 8, 4>(x, g, x_halo, g_halo, acc, out, send, own, u0, v0, blocks, L, S2, S3, C, H, sh1,
                                 sh2, sh3, mu, num_iters, grad_steps, eps, first, last, scale, stream);
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
      static_cast<const T*>(g_halo), static_cast<float*>(acc), static_cast<T*>(out), static_cast<float*>(send),
      static_cast<float*>(own), u0, v0, L, S2, S3, C, d, p, H, sh1, sh2, sh3, mu, num_iters, grad_steps, eps, first,
      last, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tail(const void* own, const void* recv, void* out, int64_t B, int64_t L, int64_t R, int H,
                        const TailShifts& sh, float scale, cudaStream_t stream) {
  const int64_t blocks = (B * H * R + kThreads - 1) / kThreads;
  slab_tail_kernel<T><<<static_cast<unsigned>(blocks < 65535 * 16 ? blocks : 65535 * 16), kThreads, 0, stream>>>(
      static_cast<const float*>(own), static_cast<const float*>(recv), static_cast<T*>(out), B, L, R, H, sh, scale);
  return cudaGetLastError();
}

}  // namespace

// One shift pass of the backward on one slab.  x, g, out (dx): (B, L, S2, S3,
// C) contiguous, of `dtype`; acc: the same shape in f32 (unused when first &&
// last); x_halo, g_halo: (B, H, S2, S3, C) of `dtype`, H the largest s1 of
// the call (unused when H == 0); send: this shift's slot (B, sh1, S2, S3, C)
// in f32 (unused when sh1 == 0); own: this shift's edge slot (B, H, S2, S3,
// C) in f32 (unused when H == 0); u0: (d,) f32; v0: (p^3,) f32.  Shifts are
// in [0, p), sh1 <= H < p; grad_steps in [1, num_iters] is the number of
// trailing iterations differentiated.  Writes the rows [0, L - H) of the
// pass, its edge slot's rows [0, H - sh1) and `send`.
extern "C" int ftt_windowed_nmf_slab_shift_bwd(const void* x, const void* g, const void* x_halo, const void* g_halo,
                                               void* acc, void* out, void* send, void* own, const void* u0,
                                               const void* v0, int dtype, int B, int L, int S2, int S3, int C, int d,
                                               int p, int H, int sh1, int sh2, int sh3, int mu, int num_iters,
                                               int grad_steps, float eps, int first, int last, float scale,
                                               void* stream) {
  if (d < 1 || d > kThreads || C % d || L % p || S2 % p || S3 % p || sh1 < 0 || sh1 > H || H >= p ||
      num_iters < 1 || grad_steps < 1 || grad_steps > num_iters ||
      (H > 0 && (x_halo == nullptr || g_halo == nullptr || own == nullptr)) || (sh1 > 0 && send == nullptr)) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto fu0 = static_cast<const float*>(u0);
  auto fv0 = static_cast<const float*>(v0);
  cudaError_t err;
  if (dtype == ftt::kFloat32) {
    err = launch<float>(x, g, x_halo, g_halo, acc, out, send, own, fu0, fv0, B, L, S2, S3, C, d, p, H, sh1, sh2, sh3,
                        mu, num_iters, grad_steps, eps, first, last, scale, s);
  } else if (dtype == ftt::kBFloat16) {
    err = launch<__nv_bfloat16>(x, g, x_halo, g_halo, acc, out, send, own, fu0, fv0, B, L, S2, S3, C, d, p, H, sh1,
                                sh2, sh3, mu, num_iters, grad_steps, eps, first, last, scale, s);
  } else if (dtype == ftt::kFloat16) {
    err = launch<__half>(x, g, x_halo, g_halo, acc, out, send, own, fu0, fv0, B, L, S2, S3, C, d, p, H, sh1, sh2,
                         sh3, mu, num_iters, grad_steps, eps, first, last, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The ordered tail: the slab's last H rows of dx.  own: (n_shifts, B, H, R)
// f32, the passes' edge slots; recv: the routed rows that arrived from the
// right neighbour, each shift's (B, s1, R) f32 in order (shifts with s1 = 0
// hold none); out: (B, L, R) of `dtype`, R = S2 * S3 * C; s1: the n_shifts
// host ints s1 of the passes, in pass order, each in [0, H]; scale:
// 1 / n_shifts.  Sums each element's passes in order.
extern "C" int ftt_windowed_nmf_slab_tail(const void* own, const void* recv, void* out, int dtype, int B, int L,
                                          long long R, int H, int n_shifts, const int* s1, float scale,
                                          void* stream) {
  if (B < 1 || H < 1 || H > L || R < 1 || n_shifts < 1 || n_shifts > kMaxTailShifts || s1 == nullptr ||
      own == nullptr || recv == nullptr) {
    return cudaErrorInvalidValue;
  }
  TailShifts sh{};
  sh.n = n_shifts;
  for (int k = 0; k < n_shifts; ++k) {
    sh.s1[k] = s1[k];
    if (sh.s1[k] < 0 || sh.s1[k] > H) return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == ftt::kFloat32) {
    err = launch_tail<float>(own, recv, out, B, L, R, H, sh, scale, s);
  } else if (dtype == ftt::kBFloat16) {
    err = launch_tail<__nv_bfloat16>(own, recv, out, B, L, R, H, sh, scale, s);
  } else if (dtype == ftt::kFloat16) {
    err = launch_tail<__half>(own, recv, out, B, L, R, H, sh, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
