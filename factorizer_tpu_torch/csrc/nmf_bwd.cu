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
// What the design does about it: what K1's backward does, without the window
// arithmetic: a block's matrix is one contiguous run of M * N elements, so x
// and g are read and dx is written fully coalesced, and the transposed
// staging in shared memory ([N][M + 1]) keeps both the loads' stores and the
// row-wise sweeps free of bank conflicts.  Small matrices (N and M up to 64)
// take blocks of 64 threads, so that a 8 x 64 matrix does not idle three
// quarters of a 256-thread block.
#include "rank1_nmf_bwd.cuh"

namespace {

// One (M, N) matrix of a contiguous batch under the names the shared sweep
// uses: d = M rows of x (the length of u), P3 = N columns (the length of v).
struct FlatMatrix {
  static constexpr bool kHalo = false;
  int d, P3;
  int64_t base;

  __device__ FlatMatrix(int M, int N) : d(M), P3(N), base(static_cast<int64_t>(blockIdx.x) * M * N) {}

  // Element e of the row-major (M, N) matrix is (q = column n, di = row m).
  __device__ int64_t locate(int e, int& q, int& di) const {
    di = e / P3;
    q = e % P3;
    return base + e;
  }
};

template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads)
nmf_reconstruct_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                           const float* __restrict__ u0, const float* __restrict__ v0, int M, int N,
                           int mu, int num_iters, int grad_steps, float eps) {
  const FlatMatrix mat(M, N);
  extern __shared__ float smem[];
  ftt::rank1_nmf_bwd_block<T, FlatMatrix, kThreads>(mat, x, g, nullptr, nullptr, nullptr, dx, nullptr, u0, v0, mu,
                                                   num_iters, grad_steps, eps, /*first=*/1, /*last=*/1, /*scale=*/1.f,
                                                   smem);
}

template <typename T, int kThreads>
cudaError_t launch(const void* x, const void* g, void* dx, const float* u0, const float* v0, int64_t n_mats,
                   int M, int N, int mu, int num_iters, int grad_steps, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ftt::rank1_bwd_smem_floats(N, M, num_iters, kThreads);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = nmf_reconstruct_bwd_kernel<T, kThreads>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(n_mats), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx), u0, v0, M, N, mu, num_iters,
      grad_steps, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_size(const void* x, const void* g, void* dx, const float* u0, const float* v0, int64_t n_mats,
                        int M, int N, int mu, int num_iters, int grad_steps, float eps, cudaStream_t stream) {
  if (M <= 64 && N <= 64) {
    return launch<T, 64>(x, g, dx, u0, v0, n_mats, M, N, mu, num_iters, grad_steps, eps, stream);
  }
  return launch<T, 256>(x, g, dx, u0, v0, n_mats, M, N, mu, num_iters, grad_steps, eps, stream);
}

}  // namespace

// x, g, dx: (n_mats, M, N) contiguous, of `dtype`; u0: (M,) f32; v0: (N,) f32;
// M in [1, 256]; grad_steps in [1, num_iters] is the number of trailing
// iterations differentiated.  Returns cudaGetLastError().
extern "C" int ftt_nmf_reconstruct_bwd(const void* x, const void* g, void* dx, const void* u0, const void* v0,
                                       int dtype, long long n_mats, int M, int N, int mu, int num_iters,
                                       int grad_steps, float eps, void* stream) {
  if (n_mats < 1 || n_mats > 2147483647LL || M < 1 || M > 256 || N < 1 || num_iters < 1 || grad_steps < 1 ||
      grad_steps > num_iters) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto fu0 = static_cast<const float*>(u0);
  auto fv0 = static_cast<const float*>(v0);
  cudaError_t err;
  if (dtype == ftt::kFloat32) {
    err = launch_size<float>(x, g, dx, fu0, fv0, n_mats, M, N, mu, num_iters, grad_steps, eps, s);
  } else if (dtype == ftt::kBFloat16) {
    err = launch_size<__nv_bfloat16>(x, g, dx, fu0, fv0, n_mats, M, N, mu, num_iters, grad_steps, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
