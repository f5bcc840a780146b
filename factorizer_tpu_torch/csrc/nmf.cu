// K4, forward: NMF of every matrix of a flat batch, rank 1 to 4, from shared tables.
//
// Replaces the Pallas kernel `_kernel` (factorizer_tpu/ops/pallas/
// nmf_kernel.py:142, launched at :217 under `nmf_reconstruct`, :176).  For
// each matrix x (M, N) of the batch it starts from the tables u0 (M, R) and
// v0 (N, R), runs `num_iters` times "update u from (x, v), then v from
// (x^T, u)", and writes u v^T in x's dtype.  One update of u, with
// a = x v (M, R) and b = v^T v (R, R):
//   HALS  column by column (Gauss-Seidel: column r sees the columns j < r of
//         this sweep and the old columns j > r):
//         u[:, r] = relu((a[:, r] - sum_{j != r} u[:, j] b[j, r] + eps) / (b[r, r] + eps));
//   MU    u = (u * a + eps) / (u b + eps), every column from the old u.
// The update of v is the same with x^T and u.  All of it runs in f32;
// eps = 1e-16 makes an all-zero matrix give eps / eps = 1, so the file must
// not be built with --use_fast_math (exact division and denormals matter).
//
// What bounds it on the H100: memory.  Per element it does 4 R flops per
// iteration and 2 R for the product (22 at rank 1, 88 at rank 4, five
// iterations) against 8 bytes in f32 (x read, y written): the 2.15 GB of the
// (131072, 8, 512) batch take 1.28 ms at 3.35 TB/s, its 5.9 GFLOP 0.09 ms.
//
// What the design does about it: one block per matrix stages it once in
// shared memory, transposed to [N][M + 1] so that the thread that owns row n
// reads it without bank conflicts, and keeps u, v and the R x R Gram matrix
// on chip for the whole solve; device memory sees one coalesced read of x
// and one coalesced write of y.  Thread n owns row n of v, thread m row m of
// u: the Gauss-Seidel sweep runs over the R columns of one row, so it is
// thread-local.  Only the M x R sums over n (partial sums per chunk of rows,
// then one pass over the chunks) and the Gram matrix of v (`block_sum_vec`)
// cross threads; the Gram matrix of u is recomputed by every thread from
// shared memory.  The block has as many threads as N needs, up to 256.  The
// TPU kernel's batch tiles, its zero-matrix padding and its VMEM budget have
// no counterpart: a ragged batch is just another number of blocks.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 227 * 1024;

// One row `f` (R entries) of a factor, from its row `a` of x v (or x^T u) and
// the Gram matrix `b` of the other factor.
template <int R>
__device__ __forceinline__ void update_row(float (&f)[R], const float (&a)[R], const float (&b)[R * R],
                                           int mu, float eps) {
  if (mu) {
    float nf[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float den = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) den += f[j] * b[j * R + r];
      nf[r] = (f[r] * a[r] + eps) / (den + eps);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) f[r] = nf[r];
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j != r) s += f[j] * b[j * R + r];
      }
      f[r] = fmaxf((a[r] - s + eps) / (b[r * R + r] + eps), 0.f);
    }
  }
}

// Work items of the sums over n: `nch` chunks of rows for each of the M columns.
__host__ __device__ inline int chunk_count(int threads, int M) { return threads / M > 0 ? threads / M : 1; }

template <int R>
size_t smem_floats(int M, int N, int threads) {
  const size_t ld = M | 1;
  return static_cast<size_t>(N) * ld + static_cast<size_t>(N + M) * R +
         static_cast<size_t>(chunk_count(threads, M)) * M * R + 9 * R * R;
}

template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads)
nmf_reconstruct_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ u0,
                       const float* __restrict__ v0, int M, int N, int mu, int num_iters, float eps) {
  extern __shared__ float smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const int ld = M | 1;                  // odd row length: conflict-free column reads
  const int nch = chunk_count(threads, M);
  float* X = smem;                       // [N][ld]  x transposed
  float* v = X + N * ld;                 // [N][R]
  float* u = v + N * R;                  // [M][R]
  float* part = u + M * R;               // [nch * M][R]
  float* red = part + nch * M * R;       // [9][R * R]

  const int n_elem = M * N;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n_elem;
  for (int e = tid; e < n_elem; e += threads) {
    X[(e % N) * ld + e / N] = ftt::to_float(x[base + e]);
  }
  for (int i = tid; i < M * R; i += threads) u[i] = u0[i];
  float b[R * R];                        // v^T v, then u^T u
#pragma unroll
  for (int k = 0; k < R * R; ++k) b[k] = 0.f;
  for (int n = tid; n < N; n += threads) {
    float vn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[n * R + r] = vn[r] = v0[n * R + r];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int s = 0; s < R; ++s) b[r * R + s] += vn[r] * vn[s];
    }
  }
  ftt::block_sum_vec<R * R>(b, red);     // ends with a barrier: X, u and v are in place

  for (int it = 0; it < num_iters; ++it) {
    // u from (x, v): a = x v, summed over n in nch chunks per column m.
    for (int w = tid; w < nch * M; w += threads) {
      const int ch = w / M, m = w % M;
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = 0.f;
      for (int n = ch; n < N; n += nch) {
        const float xv = X[n * ld + m];
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] += xv * v[n * R + r];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) part[w * R + r] = s[r];
    }
    __syncthreads();
    for (int m = tid; m < M; m += threads) {
      float a[R], f[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a[r] = 0.f;
        f[r] = u[m * R + r];
      }
      for (int ch = 0; ch < nch; ++ch) {
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] += part[(ch * M + m) * R + r];
      }
      update_row<R>(f, a, b, mu, eps);
#pragma unroll
      for (int r = 0; r < R; ++r) u[m * R + r] = f[r];
    }
    __syncthreads();

    // v from (x^T, u): row n of x^T u is thread-local; u^T u from shared memory.
#pragma unroll
    for (int k = 0; k < R * R; ++k) b[k] = 0.f;
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int s = 0; s < R; ++s) b[r * R + s] += u[m * R + r] * u[m * R + s];
      }
    }
    float vv[R * R];
#pragma unroll
    for (int k = 0; k < R * R; ++k) vv[k] = 0.f;
    for (int n = tid; n < N; n += threads) {
      float a[R], f[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a[r] = 0.f;
        f[r] = v[n * R + r];
      }
      for (int m = 0; m < M; ++m) {
        const float xv = X[n * ld + m];
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] += xv * u[m * R + r];
      }
      update_row<R>(f, a, b, mu, eps);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[n * R + r] = f[r];
#pragma unroll
        for (int s = 0; s < R; ++s) vv[r * R + s] += f[r] * f[s];
      }
    }
    ftt::block_sum_vec<R * R>(vv, red);  // the next iteration's v^T v; its barriers publish v
#pragma unroll
    for (int k = 0; k < R * R; ++k) b[k] = vv[k];
  }

  for (int e = tid; e < n_elem; e += threads) {
    const int m = e / N, n = e % N;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) s += u[m * R + r] * v[n * R + r];
    y[base + e] = ftt::from_float<T>(s);
  }
}

template <typename T, int R>
cudaError_t launch(const void* x, void* y, const float* u0, const float* v0, int64_t n_mats, int M, int N,
                   int mu, int num_iters, float eps, cudaStream_t stream) {
  int threads = (N + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const size_t smem = sizeof(float) * smem_floats<R>(M, N, threads);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = nmf_reconstruct_kernel<T, R>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(n_mats), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), u0, v0, M, N, mu, num_iters, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rank(int rank, const void* x, void* y, const float* u0, const float* v0, int64_t n_mats,
                        int M, int N, int mu, int num_iters, float eps, cudaStream_t stream) {
  switch (rank) {
    case 1: return launch<T, 1>(x, y, u0, v0, n_mats, M, N, mu, num_iters, eps, stream);
    case 2: return launch<T, 2>(x, y, u0, v0, n_mats, M, N, mu, num_iters, eps, stream);
    case 3: return launch<T, 3>(x, y, u0, v0, n_mats, M, N, mu, num_iters, eps, stream);
    case 4: return launch<T, 4>(x, y, u0, v0, n_mats, M, N, mu, num_iters, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (n_mats, M, N) contiguous, of `dtype`; u0: (M, rank) f32; v0: (N, rank)
// f32; rank in [1, 4]; n_mats in [1, 2^31).  The matrix and its factors must
// fit a block's shared memory (the wrapper's `supports` states the rule).
// Returns cudaGetLastError().
extern "C" int ftt_nmf_reconstruct(const void* x, void* y, const void* u0, const void* v0, int dtype,
                                   long long n_mats, int M, int N, int rank, int mu, int num_iters,
                                   float eps, void* stream) {
  if (n_mats < 1 || n_mats > 2147483647LL || M < 1 || N < 1 || num_iters < 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto fu0 = static_cast<const float*>(u0);
  auto fv0 = static_cast<const float*>(v0);
  cudaError_t err;
  if (dtype == ftt::kFloat32) {
    err = launch_rank<float>(rank, x, y, fu0, fv0, n_mats, M, N, mu, num_iters, eps, s);
  } else if (dtype == ftt::kBFloat16) {
    err = launch_rank<__nv_bfloat16>(rank, x, y, fu0, fv0, n_mats, M, N, mu, num_iters, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
