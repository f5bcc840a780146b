// K4, backward at rank 1: dx of the flat NMF for a cotangent g.
//
// The JAX package has no backward kernel for `nmf_reconstruct`: its `_bwd`
// (factorizer_tpu/ops/pallas/nmf_kernel.py:272) reruns the solve in plain XLA
// and differentiates that.  Here the rank-1 backward, which every 2-D and
// every `use_windowed: False` configuration of the bundles trains with, is a
// kernel: the reverse sweep K1's backward runs on a window
// (rank1_nmf_bwd.cuh), on a matrix of the flat batch instead.  A block
// reruns its solve, so nothing but x is kept between forward and backward.
// Ranks 2 to 4 differentiate a recompute written in torch operations, in the
// wrapper.
//
// What bounds it on the H100: f32 arithmetic, narrowly, as K1's backward: 64
// flops per element at five differentiated iterations against 12 bytes in
// f32 (x and g read, dx written).
//
// What the design does about it (the launch plan is nmf_plan.cuh): what K1's
// backward does, on a matrix of the flat batch instead of a window.  At the
// bundles' sizes, M = 8 and N = 512 or 64, the register-resident reverse
// sweep (rank1_group_bwd, rank1_nmf_bwd.cuh) under the flat addressing
// (FlatMatrix, windowed_nmf.cuh): a thread group holds the matrix, its x and
// g / dx columns in registers (4 warps a matrix at N = 512, one at N = 64,
// four matrices to a 128-thread block), every sum over columns a shuffle
// reduce-scatter with one barrier, only the iterates in shared memory; a
// warp reads and writes each row of the matrix as 32 consecutive elements.
// Any other size takes a block a matrix in shared memory
// (rank1_nmf_bwd_block): the matrix is one contiguous run of M * N elements,
// read and written coalesced, and the transposed staging ([N][M + 1]) keeps
// both the loads' stores and the row-wise sweeps free of bank conflicts;
// small matrices (N and M up to 64) take blocks of 64 threads.
#include "nmf_plan.cuh"

namespace {

// Any other size: one block per matrix, in shared memory.
template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads)
nmf_reconstruct_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                           const float* __restrict__ u0, const float* __restrict__ v0, int M, int N,
                           int mu, int num_iters, int grad_steps, float eps) {
  const ftt::FlatMatrix mat(M, N, blockIdx.x);
  extern __shared__ float smem[];
  ftt::rank1_nmf_bwd_block<T, ftt::FlatMatrix, kThreads>(mat, x, g, nullptr, nullptr, nullptr, dx, nullptr, nullptr,
                                                         u0, v0, mu, num_iters, grad_steps, eps, /*first=*/1, /*last=*/1,
                                                         /*scale=*/1.f, smem);
}

// M = 8, N = kP^3: a thread group per matrix (Group<8, kP>), kGroups to a block.
template <typename T, int kP>
__global__ void __launch_bounds__(ftt::kNmfGroupBlock, ftt::nmf_group_min_blocks(1, true, kP * kP * kP))
nmf_reconstruct_bwd_group_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                                 const float* __restrict__ u0, const float* __restrict__ v0, int64_t n_mats, int mu,
                                 int num_iters, int grad_steps, float eps) {
  using G = ftt::Group<8, kP>;
  extern __shared__ float smem[];
  const int group = threadIdx.x / G::kThreads, lane_g = threadIdx.x % G::kThreads;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * G::kGroups + group;
  if (m >= n_mats) return;  // a whole group leaves together
  const ftt::FlatMatrix mat(8, G::kP3, m);
  float* sm = smem + group * ftt::rank1_group_bwd_smem_floats(G::kP3, 8, num_iters, G::kWarps);
  ftt::rank1_group_bwd<T, ftt::FlatMatrix, 8, kP>(mat, x, g, nullptr, nullptr, nullptr, dx, nullptr, nullptr, u0, v0,
                                                  mu, num_iters, grad_steps, eps, /*first=*/1, /*last=*/1, /*scale=*/1.f,
                                                  sm, lane_g);
}

template <typename T>
cudaError_t launch_plan(const ftt::NmfPlan& plan, const void* x, const void* g, void* dx, const float* u0,
                        const float* v0, long long n_mats, int M, int N, int mu, int num_iters, int grad_steps,
                        float eps, cudaStream_t stream) {
  const T* tx = static_cast<const T*>(x);
  const T* tg = static_cast<const T*>(g);
  T* tdx = static_cast<T*>(dx);
  const unsigned blocks = static_cast<unsigned>(plan.blocks);
  cudaError_t err;
  if (plan.route == ftt::kNmfRegisters) {
    if (N == 512) {
      if ((err = ftt::allow_nmf_smem<nmf_reconstruct_bwd_group_kernel<T, 8>>(plan.smem)) != cudaSuccess) return err;
      nmf_reconstruct_bwd_group_kernel<T, 8><<<blocks, plan.threads, plan.smem, stream>>>(
          tx, tg, tdx, u0, v0, n_mats, mu, num_iters, grad_steps, eps);
    } else {
      if ((err = ftt::allow_nmf_smem<nmf_reconstruct_bwd_group_kernel<T, 4>>(plan.smem)) != cudaSuccess) return err;
      nmf_reconstruct_bwd_group_kernel<T, 4><<<blocks, plan.threads, plan.smem, stream>>>(
          tx, tg, tdx, u0, v0, n_mats, mu, num_iters, grad_steps, eps);
    }
  } else if (plan.threads == 64) {
    if ((err = ftt::allow_nmf_smem<nmf_reconstruct_bwd_kernel<T, 64>>(plan.smem)) != cudaSuccess) return err;
    nmf_reconstruct_bwd_kernel<T, 64><<<blocks, 64, plan.smem, stream>>>(tx, tg, tdx, u0, v0, M, N, mu, num_iters,
                                                                          grad_steps, eps);
  } else {
    if ((err = ftt::allow_nmf_smem<nmf_reconstruct_bwd_kernel<T, 256>>(plan.smem)) != cudaSuccess) return err;
    nmf_reconstruct_bwd_kernel<T, 256><<<blocks, 256, plan.smem, stream>>>(tx, tg, tdx, u0, v0, M, N, mu, num_iters,
                                                                            grad_steps, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x, g, dx: (n_mats, M, N) contiguous, of `dtype`; u0: (M,) f32; v0: (N,) f32;
// grad_steps in [1, num_iters] is the number of trailing iterations
// differentiated.  The call runs as nmf_plan (nmf_plan.cuh) says, `route`
// passed to it as `want` (-1: the plan's choice); a call it refuses returns
// cudaErrorInvalidValue.  Returns cudaGetLastError().
extern "C" int ftt_nmf_reconstruct_bwd(const void* x, const void* g, void* dx, const void* u0, const void* v0,
                                       int dtype, long long n_mats, int M, int N, int mu, int num_iters,
                                       int grad_steps, float eps, int route, void* stream) {
  if ((dtype != ftt::kFloat32 && dtype != ftt::kBFloat16 && dtype != ftt::kFloat16) || n_mats > 2147483647LL ||
      grad_steps < 1 || grad_steps > num_iters) {
    return cudaErrorInvalidValue;
  }
  const ftt::NmfPlan plan =
      ftt::nmf_plan(1, M, N, dtype == ftt::kFloat32 ? 4 : 2, num_iters, n_mats, /*backward=*/true, route);
  if (plan.route == ftt::kNmfNone) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto fu0 = static_cast<const float*>(u0);
  auto fv0 = static_cast<const float*>(v0);
  const cudaError_t err =
      dtype == ftt::kFloat32
          ? launch_plan<float>(plan, x, g, dx, fu0, fv0, n_mats, M, N, mu, num_iters, grad_steps, eps, s)
      : dtype == ftt::kBFloat16
          ? launch_plan<__nv_bfloat16>(plan, x, g, dx, fu0, fv0, n_mats, M, N, mu, num_iters, grad_steps, eps, s)
          : launch_plan<__half>(plan, x, g, dx, fu0, fv0, n_mats, M, N, mu, num_iters, grad_steps, eps, s);
  return static_cast<int>(err);
}
