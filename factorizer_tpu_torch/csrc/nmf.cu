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
// What the design does about it (the launch plan is nmf_plan.cuh):
//   * At the bundles' sizes, M = 8 and N = 512 or 64, a thread group holds
//     the matrix in registers for the whole solve, the layout of K1's
//     factors pass (Group<8, kP>, windowed_nmf.cuh) with row q of the solve
//     the matrix's column n and channel di its row m: 4 warps a matrix at
//     N = 512 (4 columns of 8 a thread), one warp at N = 64 (2 columns), four
//     matrices to a 128-thread block.  A warp reads and writes each row of x
//     and y as 32 consecutive elements.  Per iteration one reduction crosses
//     the group, the shuffle reduce-scatter of x v (8 R sums) and of the
//     Gram matrix v^T v (group_sum9 at rank 1, group_sum above it), one
//     barrier; every thread then updates all of u (so no thread idles and no
//     barrier guards u), forms u^T u itself, and updates its own rows of v,
//     whose x^T u is thread-local; HALS's sweep over a row's R columns stays
//     thread-local.  At rank 1 this is K1's solve itself
//     (rank1_group_solve), so K4 on a folded volume gives K1's bits at one
//     zero shift.  Loads are direct: a persistent kernel that kept the next
//     matrix's copy in flight (cp.async into shared memory) measured slower
//     at every rank-1 shape (PERF.md, the K4 tables); the 5 to 9 groups an SM holds
//     hide the latency.
//   * Any other size takes one block a matrix in shared memory (the first
//     design of this kernel): the matrix staged transposed to [N][M | 1], so that the thread
//     that owns column n reads it without bank conflicts, u, v and the Gram
//     matrix on chip; the M x R sums over n in partial sums per chunk of
//     columns, then one pass over the chunks.
// The TPU kernel's batch tiles, its zero-matrix padding and its VMEM budget
// have no counterpart: a ragged batch is just another number of blocks.
#include "nmf_plan.cuh"

namespace {

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

template <typename T, int R>
__global__ void __launch_bounds__(ftt::kNmfMaxThreads)
nmf_reconstruct_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ u0,
                       const float* __restrict__ v0, int M, int N, int mu, int num_iters, float eps) {
  extern __shared__ float smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const int ld = M | 1;                  // odd row length: conflict-free column reads
  const int nch = threads / M > 0 ? threads / M : 1;
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

// update_row for the register solve, where every thread updates all rows of
// u itself: HALS's quotients along column r share the denominator
// b[r][r] + eps, so each row takes the product with its reciprocal (within an
// ulp of the quotient, as rank1_group_solve does) where update_row divides.
template <int R>
__device__ __forceinline__ void group_update_row(float (&f)[R], const float (&a)[R], const float (&b)[R * R],
                                                 int mu, float eps) {
  if (mu) {
    update_row<R>(f, a, b, mu, eps);
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j != r) s += f[j] * b[j * R + r];
    }
    f[r] = fmaxf((a[r] - s + eps) * (1.f / (b[r * R + r] + eps)), 0.f);
  }
}

// Ranks 2 to 4 of the register solve on rows already in registers: K1's
// rank-1 iteration (rank1_group_solve) widened to R columns.  Every thread
// ends with all of u (8 x R) and the R entries of v for its own columns
// q = lane_g + kThreads * k.
template <int kP, int R>
__device__ __forceinline__ void rank_group_iterate(const float* __restrict__ u0, const float* __restrict__ v0, int mu,
                                                   int num_iters, float eps, float* red, int lane_g, float (&u)[8][R],
                                                   float (&v)[ftt::Group<8, kP>::kRows][R],
                                                   const float (&X)[ftt::Group<8, kP>::kRows][8]) {
  using G = ftt::Group<8, kP>;
  constexpr int kSums = ftt::nmf_group_sums(R);
#pragma unroll
  for (int k = 0; k < G::kRows; ++k) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[k][r] = v0[(lane_g + G::kThreads * k) * R + r];
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
#pragma unroll
    for (int r = 0; r < R; ++r) u[m][r] = u0[m * R + r];
  }
  for (int it = 0; it < num_iters; ++it) {
    // x v (s[m R + r]) and the upper triangle of v^T v (s[8 R ...]), summed over the group's columns.
    float s[kSums];
#pragma unroll
    for (int i = 0; i < kSums; ++i) s[i] = 0.f;
#pragma unroll
    for (int k = 0; k < G::kRows; ++k) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int r = 0; r < R; ++r) s[m * R + r] = fmaf(X[k][m], v[k][r], s[m * R + r]);
      }
      int t = 8 * R;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = r; c < R; ++c, ++t) s[t] = fmaf(v[k][r], v[k][c], s[t]);
      }
    }
    ftt::group_sum<G::kWarps, kSums>(s, red, it & 1);
    float b[R * R];
    {
      int t = 8 * R;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = r; c < R; ++c, ++t) b[r * R + c] = b[c * R + r] = s[t];
      }
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = s[m * R + r];
      group_update_row<R>(u[m], a, b, mu, eps);
    }
    // u^T u, then this thread's rows of v from their x^T u.
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = r; c < R; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < 8; ++m) acc = fmaf(u[m][r], u[m][c], acc);
        b[r * R + c] = b[c * R + r] = acc;
      }
    }
#pragma unroll
    for (int k = 0; k < G::kRows; ++k) {
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < 8; ++m) acc = fmaf(X[k][m], u[m][r], acc);
        a[r] = acc;
      }
      group_update_row<R>(v[k], a, b, mu, eps);
    }
  }
}

// The register route: group `threadIdx.x / kThreads` of block b holds matrix
// b * kGroups + group, solves it and writes u v^T for its own columns.
template <typename T, int kP, int R>
__global__ void __launch_bounds__(ftt::kNmfGroupBlock, ftt::nmf_group_min_blocks(R, false, kP * kP * kP))
nmf_reconstruct_group_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ u0,
                             const float* __restrict__ v0, int64_t n_mats, int mu, int num_iters, float eps) {
  using G = ftt::Group<8, kP>;
  __shared__ __align__(16) float red[G::kGroups][2 * G::kWarps * ftt::nmf_group_sum_stride(R)];
  const int group = threadIdx.x / G::kThreads, lane_g = threadIdx.x % G::kThreads;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * G::kGroups + group;
  if (m >= n_mats) return;  // a whole group leaves together
  const ftt::FlatMatrix mat(8, G::kP3, m);
  float X[G::kRows][8];
  if constexpr (R == 1) {
    float u[8], v[G::kRows];
    ftt::rank1_group_solve<T, ftt::FlatMatrix, 8, kP>(mat, x, nullptr, u0, v0, mu, num_iters, eps, red[group], lane_g,
                                                      u, v, X);
#pragma unroll
    for (int k = 0; k < G::kRows; ++k) {
      float r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = __fmul_rn(u[i], v[k]);  // K1's reconstruct pass rounds so
      ftt::store8_strided(y + mat.row_offset(lane_g + G::kThreads * k), G::kP3, r);
    }
  } else {
    float u[8][R], v[G::kRows][R];
    ftt::group_load_rows<T, ftt::FlatMatrix, 8, kP>(mat, x, nullptr, lane_g, X);
    rank_group_iterate<kP, R>(u0, v0, mu, num_iters, eps, red[group], lane_g, u, v, X);
#pragma unroll
    for (int k = 0; k < G::kRows; ++k) {
      float r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float acc = __fmul_rn(u[i][0], v[k][0]);
#pragma unroll
        for (int c = 1; c < R; ++c) acc = fmaf(u[i][c], v[k][c], acc);
        r[i] = acc;
      }
      ftt::store8_strided(y + mat.row_offset(lane_g + G::kThreads * k), G::kP3, r);
    }
  }
}

template <typename T, int R>
cudaError_t launch_shared(const ftt::NmfPlan& plan, const void* x, void* y, const float* u0, const float* v0, int M,
                          int N, int mu, int num_iters, float eps, cudaStream_t stream) {
  const cudaError_t err = ftt::allow_nmf_smem<nmf_reconstruct_kernel<T, R>>(plan.smem);
  if (err != cudaSuccess) return err;
  nmf_reconstruct_kernel<T, R><<<static_cast<unsigned>(plan.blocks), plan.threads, plan.smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), u0, v0, M, N, mu, num_iters, eps);
  return cudaGetLastError();
}

template <typename T, int kP, int R>
cudaError_t launch_group(const ftt::NmfPlan& plan, const void* x, void* y, const float* u0, const float* v0,
                         int64_t n_mats, int mu, int num_iters, float eps, cudaStream_t stream) {
  nmf_reconstruct_group_kernel<T, kP, R><<<static_cast<unsigned>(plan.blocks), plan.threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), u0, v0, n_mats, mu, num_iters, eps);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_rank(const ftt::NmfPlan& plan, const void* x, void* y, const float* u0,
                        const float* v0, int64_t n_mats, int M, int N, int mu, int num_iters, float eps,
                        cudaStream_t stream) {
  if (plan.route == ftt::kNmfShared) return launch_shared<T, R>(plan, x, y, u0, v0, M, N, mu, num_iters, eps, stream);
  if (N == 512) return launch_group<T, 8, R>(plan, x, y, u0, v0, n_mats, mu, num_iters, eps, stream);
  return launch_group<T, 4, R>(plan, x, y, u0, v0, n_mats, mu, num_iters, eps, stream);
}

template <typename T>
cudaError_t launch(const ftt::NmfPlan& plan, int rank, const void* x, void* y, const float* u0,
                   const float* v0, int64_t n_mats, int M, int N, int mu, int num_iters, float eps,
                   cudaStream_t stream) {
  switch (rank) {
    case 1: return launch_rank<T, 1>(plan, x, y, u0, v0, n_mats, M, N, mu, num_iters, eps, stream);
    case 2: return launch_rank<T, 2>(plan, x, y, u0, v0, n_mats, M, N, mu, num_iters, eps, stream);
    case 3: return launch_rank<T, 3>(plan, x, y, u0, v0, n_mats, M, N, mu, num_iters, eps, stream);
    case 4: return launch_rank<T, 4>(plan, x, y, u0, v0, n_mats, M, N, mu, num_iters, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (n_mats, M, N) contiguous, of `dtype`; u0: (M, rank) f32; v0: (N, rank)
// f32; rank in [1, 4]; n_mats in [1, 2^31).  The call runs as nmf_plan
// (nmf_plan.cuh) says, `route` passed to it as `want` (-1: the plan's
// choice); a call it refuses returns cudaErrorInvalidValue (the wrapper's
// `supports` states the rule).  Returns cudaGetLastError().
extern "C" int ftt_nmf_reconstruct(const void* x, void* y, const void* u0, const void* v0, int dtype,
                                   long long n_mats, int M, int N, int rank, int mu, int num_iters,
                                   float eps, int route, void* stream) {
  if (dtype != ftt::kFloat32 && dtype != ftt::kBFloat16 && dtype != ftt::kFloat16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ftt::NmfPlan plan =
      ftt::nmf_plan(rank, M, N, dtype == ftt::kFloat32 ? 4 : 2, num_iters, n_mats, /*backward=*/false, route);
  if (plan.route == ftt::kNmfNone || n_mats > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto fu0 = static_cast<const float*>(u0);
  auto fv0 = static_cast<const float*>(v0);
  const cudaError_t err =
      dtype == ftt::kFloat32   ? launch<float>(plan, rank, x, y, fu0, fv0, n_mats, M, N, mu, num_iters, eps, s)
      : dtype == ftt::kBFloat16 ? launch<__nv_bfloat16>(plan, rank, x, y, fu0, fv0, n_mats, M, N, mu, num_iters, eps, s)
                                : launch<__half>(plan, rank, x, y, fu0, fv0, n_mats, M, N, mu, num_iters, eps, s);
  return static_cast<int>(err);
}

// What the wrapper's mirror of nmf_plan.cuh (ops/kernels/nmf.py::nmf_plan) must agree with: out[0..7] = route
// (-1: none), threads a group, matrices a block, threads a block, shared memory a block in bytes, resident blocks
// an SM, blocks, and the kernel's __launch_bounds__ blocks.  elt: bytes of an element (4 or 2); route: as
// ftt_nmf_reconstruct's.  Returns 0.
extern "C" int ftt_nmf_plan_query(int rank, int M, int N, int elt, int num_iters, long long n_mats, int backward,
                                  int route, long long* out) {
  const ftt::NmfPlan p = ftt::nmf_plan(rank, M, N, elt, num_iters, n_mats, backward != 0, route);
  out[0] = p.route;
  out[1] = p.group_threads;
  out[2] = p.per_block;
  out[3] = p.threads;
  out[4] = p.smem;
  out[5] = p.resident;
  out[6] = p.blocks;
  out[7] = p.route == ftt::kNmfShared    ? ftt::kNmfSharedMinBlocks
         : p.route == ftt::kNmfRegisters ? ftt::nmf_group_min_blocks(rank, backward != 0, N)
                                         : 0;
  return 0;
}
