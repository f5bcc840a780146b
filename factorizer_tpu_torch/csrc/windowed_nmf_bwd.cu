// K1, backward: dx of the shifted-window rank-1 NMF for a cotangent g.
//
// Replaces the Pallas kernels `_shift_bwd_kernel` (factorizer_tpu/ops/pallas/
// windowed_nmf_kernel.py:411, launched per shift at :591) and, with the one
// zero shift, `_bwd_kernel` (:249, launched at :790).  Those take `jax.vjp`
// over the unrolled solve inside the kernel; here the reverse sweep is
// written out.  Per (sample, window, head) block, with X the p^3 x d matrix
// of the rolled volume and G the cotangent at the same wrapped coordinates
// (the adjoint of the output's inverse roll is the same roll):
//
//   forward, kept in shared memory:  u_t, v_t for t = 0..T, a_u = X v_{t-1}
//   and b_u = v_{t-1}.v_{t-1} per iteration;
//   seed (y = v_T u_T^T):  ubar = G^T v_T,  vbar = G u_T;
//   for t = T .. T-g+1 (g = differentiated iterations):
//     V update, v_t = f(a, b, v_{t-1}) with a = X u_t (p^3 values), b = u_t.u_t:
//       HALS  zbar = vbar [v_t > 0];  abar = zbar / (b + eps);
//             bbar = -sum zbar v_t / (b + eps);  nothing flows to v_{t-1};
//       MU    nbar = vbar / den, dbar = -vbar v_t / den, den = v_{t-1} b + eps;
//             abar = nbar v_{t-1};  bbar = sum dbar v_{t-1};
//             vbar_prev = nbar a + dbar b;
//       dX += abar u_t^T;  ubar += X^T abar + 2 bbar u_t;
//     U update, the mirror image with a = X^T v_{t-1}, b = v_{t-1}.v_{t-1};
//       dX += v_{t-1} abar^T;  vbar = vbar_prev + X abar + 2 bbar v_{t-1}.
//
// The first T-g iterations see a stopped copy of x and the factors are
// stopped after them, so nothing flows past iteration T-g+1.  ReLU's
// gradient at exactly 0 is 0 (`> 0`).  All-zero windows make b = u.u fall
// below eps = 1e-16, so 1/(b + eps) ~ 1e16 multiplies the cotangents; the
// result is finite and the file must not be built with --use_fast_math
// (flush-to-zero and approximate division change these values).
//
// What bounds it on the H100: f32 arithmetic, narrowly.  Per element and
// shift it does 4 flops per forward iteration, 2 for the product and the
// shift sum, 4 for the seed and 8 per differentiated iteration (66 at
// T = g = 5) against 12 bytes in f32 (x and g read, dx written): 0.53 ms of
// CUDA-core time against 0.48 ms of memory time for the (2,128^3,32) stage
// with 4 shifts.
//
// What the design does about it: nothing is stored in device memory between
// forward and backward but x; a block reruns its solve, keeping every
// iterate in shared memory (about 54 KB at d = p = 8), and the buffer that
// staged G is reused for dX.  Thread q owns row q of X, G and dX, so the
// row-wise steps need no barrier; only the d column sums per update
// (`column_dot`) and two scalar sums cross threads.  As in the forward, the
// shifts are separate launches that add into an f32 scratch in stream order.
#include "windowed_nmf.cuh"

namespace {

constexpr int kThreads = ftt::kWindowThreads;

// Shared-memory floats of one block.
inline size_t smem_floats(int P3, int d, int T) {
  return 2 * static_cast<size_t>(P3) * (d + 1)     // X, G / dX
         + static_cast<size_t>(T + 1) * (P3 + d)   // iterates v_t, u_t
         + static_cast<size_t>(T) * (d + 1)        // a_u, b_u per iteration
         + 2 * static_cast<size_t>(P3)             // vbar, abar_v
         + 3 * static_cast<size_t>(d)              // ubar, abar_u, the b-bar terms
         + kThreads + 33;                          // column_dot, block_sum
}

template <typename T, int kD, int kP>
__global__ void __launch_bounds__(kThreads)
windowed_nmf_shift_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ acc,
                              T* __restrict__ out, const float* __restrict__ u0,
                              const float* __restrict__ v0, int S1, int S2, int S3, int C, int d_rt,
                              int p_rt, int sh1, int sh2, int sh3, int mu, int num_iters,
                              int grad_steps, float eps, int first, int last, float scale) {
  const ftt::Window<kD, kP> win(d_rt, p_rt, S1, S2, S3, C, sh1, sh2, sh3);
  const int d = win.d, P3 = win.P3, nT = num_iters;
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* X = smem;                  // [P3][ld]
  float* D = X + P3 * ld;           // [P3][ld]   G, then dX
  float* V = D + P3 * ld;           // [nT + 1][P3]
  float* U = V + (nT + 1) * P3;     // [nT + 1][d]
  float* AU = U + (nT + 1) * d;     // [nT][d]    a_u of iteration t at AU[(t - 1) * d]
  float* BU = AU + nT * d;          // [nT]       b_u of iteration t at BU[t - 1]
  float* vbar = BU + nT;            // [P3]
  float* av = vbar + P3;            // [P3]       abar of the V update
  float* ubar = av + P3;            // [d]
  float* au = ubar + d;             // [d]        abar of the U update
  float* bt = au + d;               // [d]        the terms of its bbar
  float* part = bt + d;             // [kThreads]
  float* red = part + kThreads;     // [33]

  const int tid = threadIdx.x;
  const int n_elem = P3 * d;

  for (int e = tid; e < n_elem; e += kThreads) {
    const int64_t o = win.offset(e);
    X[(e / d) * ld + e % d] = ftt::to_float(x[o]);
    D[(e / d) * ld + e % d] = ftt::to_float(g[o]);
  }
  float bu_local = 0.f;
  for (int q = tid; q < P3; q += kThreads) {
    V[q] = v0[q];
    bu_local += v0[q] * v0[q];
  }
  if (tid < d) U[tid] = u0[tid];
  float bu = ftt::block_sum(bu_local, red);  // ends with a barrier

  // The solve, as the forward kernel runs it, with every iterate kept.
  for (int t = 1; t <= nT; ++t) {
    const float* vp = V + (t - 1) * P3;
    float* vt = V + t * P3;
    float* ut = U + t * d;
    const float a = ftt::column_dot(X, vp, part, P3, d, ld);
    if (tid < d) {
      const float uo = U[(t - 1) * d + tid];
      ut[tid] = mu ? (uo * a + eps) / (uo * bu + eps) : fmaxf((a + eps) / (bu + eps), 0.f);
      AU[(t - 1) * d + tid] = a;
    }
    if (tid == 0) BU[t - 1] = bu;
    __syncthreads();
    float bv = 0.f;
    for (int di = 0; di < d; ++di) bv += ut[di] * ut[di];
    float vv_local = 0.f;
    for (int q = tid; q < P3; q += kThreads) {
      float a_v = 0.f;
      for (int di = 0; di < d; ++di) a_v += X[q * ld + di] * ut[di];
      const float vo = vp[q];
      const float vn = mu ? (vo * a_v + eps) / (vo * bv + eps) : fmaxf((a_v + eps) / (bv + eps), 0.f);
      vt[q] = vn;
      vv_local += vn * vn;
    }
    bu = ftt::block_sum(vv_local, red);
  }

  // Seed: Y = v_T u_T^T, so ubar = sum_q G[q][:] v_T[q] and vbar[q] = G[q][:] . u_T.
  {
    const float* uT = U + nT * d;
    const float s = ftt::column_dot(D, V + nT * P3, part, P3, d, ld);
    if (tid < d) ubar[tid] = s;
    for (int q = tid; q < P3; q += kThreads) {
      float s_v = 0.f;
      for (int di = 0; di < d; ++di) s_v += D[q * ld + di] * uT[di];
      vbar[q] = s_v;
    }
    __syncthreads();  // every row of G is consumed; D becomes dX
    for (int q = tid; q < P3; q += kThreads) {
      for (int di = 0; di < d; ++di) D[q * ld + di] = 0.f;
    }
  }

  for (int t = nT; t > nT - grad_steps; --t) {
    const float* ut = U + t * d;
    const float* up = U + (t - 1) * d;
    const float* vt = V + t * P3;
    const float* vp = V + (t - 1) * P3;

    // V update backwards.  Rows are thread-local; ubar of this thread's
    // column is ready since the last barrier.
    float bv = 0.f;
    for (int di = 0; di < d; ++di) bv += ut[di] * ut[di];
    float bbar_local = 0.f;
    for (int q = tid; q < P3; q += kThreads) {
      const float vb = vbar[q];
      float abar, vprev;
      if (mu) {
        float a_v = 0.f;
        for (int di = 0; di < d; ++di) a_v += X[q * ld + di] * ut[di];
        const float den = vp[q] * bv + eps;
        const float nbar = vb / den;
        const float dbar = -vb * vt[q] / den;
        abar = nbar * vp[q];
        bbar_local += dbar * vp[q];
        vprev = nbar * a_v + dbar * bv;
      } else {
        const float zbar = vt[q] > 0.f ? vb : 0.f;
        abar = zbar / (bv + eps);
        bbar_local -= zbar * vt[q] / (bv + eps);
        vprev = 0.f;
      }
      av[q] = abar;
      vbar[q] = vprev;
      for (int di = 0; di < d; ++di) D[q * ld + di] += abar * ut[di];
    }
    const float bbar_v = ftt::block_sum(bbar_local, red);  // its barriers publish av
    const float xa = ftt::column_dot(X, av, part, P3, d, ld);

    // U update backwards, on the d threads that own ubar.
    const float b_u = BU[t - 1];
    if (tid < d) {
      const float ub = ubar[tid] + xa + 2.f * bbar_v * ut[tid];
      float abar, uprev, bterm;
      if (mu) {
        const float den = up[tid] * b_u + eps;
        const float nbar = ub / den;
        const float dbar = -ub * ut[tid] / den;
        abar = nbar * up[tid];
        bterm = dbar * up[tid];
        uprev = nbar * AU[(t - 1) * d + tid] + dbar * b_u;
      } else {
        const float zbar = ut[tid] > 0.f ? ub : 0.f;
        abar = zbar / (b_u + eps);
        bterm = -zbar * ut[tid] / (b_u + eps);
        uprev = 0.f;
      }
      au[tid] = abar;
      bt[tid] = bterm;
      ubar[tid] = uprev;
    }
    __syncthreads();
    float bbar_u = 0.f;
    for (int di = 0; di < d; ++di) bbar_u += bt[di];
    for (int q = tid; q < P3; q += kThreads) {
      float xa_v = 0.f;
      for (int di = 0; di < d; ++di) {
        xa_v += X[q * ld + di] * au[di];
        D[q * ld + di] += vp[q] * au[di];
      }
      vbar[q] += xa_v + 2.f * bbar_u * vp[q];
    }
    __syncthreads();  // au, bt and part are rewritten by the next iteration
  }
  __syncthreads();  // rows of dX are read across threads below

  for (int e = tid; e < n_elem; e += kThreads) {
    ftt::store_pass(acc, out, win.offset(e), D[(e / d) * ld + e % d], first, last, scale);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, void* acc, void* out, const float* u0, const float* v0,
                   int B, int S1, int S2, int S3, int C, int d, int p, int sh1, int sh2, int sh3,
                   int mu, int num_iters, int grad_steps, float eps, int first, int last, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p * p * p, d, num_iters);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  // The bundle's head_dim 8 and patch 8 get a compile-time instance.
  auto kernel = (d == 8 && p == 8) ? windowed_nmf_shift_bwd_kernel<T, 8, 8>
                                   : windowed_nmf_shift_bwd_kernel<T, 0, 0>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = static_cast<int64_t>(B) * (S1 / p) * (S2 / p) * (S3 / p) * (C / d);
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
