// The reverse sweep of a rank-1 NMF solve on one block's matrix, shared by
// K1's backward (windowed_nmf_bwd.cu: the matrix is a window of a rolled
// volume) and K4's rank-1 backward (nmf_bwd.cu: the matrix is one of a flat
// batch).  The two differ only in where element e of the matrix lies in
// device memory, which the `Addr` argument answers.  K5's backward
// (windowed_nmf_slab_bwd.cu) is K1's on a slab: a third addressing, under
// which some elements are read from halo buffers and written to a send
// buffer (`load_at`, `store_at` in windowed_nmf.cuh).
//
// With X the P3 x d matrix of the block (row q, column di), G the cotangent
// at the same places, and the solve u in R^d, v in R^P3:
//
//   forward, kept in shared memory:  u_t, v_t for t = 0..T, a_u = X v_{t-1}
//   and b_u = v_{t-1}.v_{t-1} per iteration;
//   seed (y = v_T u_T^T):  ubar = G^T v_T,  vbar = G u_T;
//   for t = T .. T-g+1 (g = differentiated iterations):
//     V update, v_t = f(a, b, v_{t-1}) with a = X u_t (P3 values), b = u_t.u_t:
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
// gradient at exactly 0 is 0 (`> 0`).  All-zero matrices make b = u.u fall
// below eps = 1e-16, so 1/(b + eps) ~ 1e16 multiplies the cotangents; the
// result is finite and the file must not be built with --use_fast_math
// (flush-to-zero and approximate division change these values).
#pragma once

#include "windowed_nmf.cuh"

namespace ftt {

// Shared-memory floats of one block of `threads` threads.
inline size_t rank1_bwd_smem_floats(int P3, int d, int T, int threads) {
  return 2 * static_cast<size_t>(P3) * (d + 1)     // X, G / dX
         + static_cast<size_t>(T + 1) * (P3 + d)   // iterates v_t, u_t
         + static_cast<size_t>(T) * (d + 1)        // a_u, b_u per iteration
         + 2 * static_cast<size_t>(P3)             // vbar, abar_v
         + 3 * static_cast<size_t>(d)              // ubar, abar_u, the b-bar terms
         + threads + 33;                           // column_dot, block_sum
}

// `win` gives d, P3 and locate(e, q, di) -> offset for e in [0, P3 * d);
// consecutive e should be consecutive addresses.  The block has kThreads
// threads, kThreads >= d.  `smem` holds rank1_bwd_smem_floats(...) floats.
// The result goes through store_at (windowed_nmf.cuh); `x_halo`, `g_halo`
// and `send` are read and written only under a slab addressing.
template <typename T, typename Addr, int kThreads>
__device__ __forceinline__ void rank1_nmf_bwd_block(
    const Addr& win, const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ x_halo,
    const T* __restrict__ g_halo, float* __restrict__ acc, T* __restrict__ out, float* __restrict__ send,
    const float* __restrict__ u0, const float* __restrict__ v0, int mu, int num_iters, int grad_steps,
    float eps, int first, int last, float scale, float* smem) {
  const int d = win.d, P3 = win.P3, nT = num_iters;
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
    int q, di;
    const int64_t o = win.locate(e, q, di);
    X[q * ld + di] = load_at<Addr>(x, x_halo, o);
    D[q * ld + di] = load_at<Addr>(g, g_halo, o);
  }
  float bu_local = 0.f;
  for (int q = tid; q < P3; q += kThreads) {
    V[q] = v0[q];
    bu_local += v0[q] * v0[q];
  }
  if (tid < d) U[tid] = u0[tid];
  float bu = block_sum(bu_local, red);  // ends with a barrier

  // The solve, as the forward kernel runs it, with every iterate kept.
  for (int t = 1; t <= nT; ++t) {
    const float* vp = V + (t - 1) * P3;
    float* vt = V + t * P3;
    float* ut = U + t * d;
    const float a = column_dot<kThreads>(X, vp, part, P3, d, ld);
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
    bu = block_sum(vv_local, red);
  }

  // Seed: Y = v_T u_T^T, so ubar = sum_q G[q][:] v_T[q] and vbar[q] = G[q][:] . u_T.
  {
    const float* uT = U + nT * d;
    const float s = column_dot<kThreads>(D, V + nT * P3, part, P3, d, ld);
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
    const float bbar_v = block_sum(bbar_local, red);  // its barriers publish av
    const float xa = column_dot<kThreads>(X, av, part, P3, d, ld);

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
    int q, di;
    const int64_t o = win.locate(e, q, di);
    store_at<Addr>(acc, out, send, o, D[q * ld + di], first, last, scale);
  }
}

}  // namespace ftt
