// The reverse sweep of a rank-1 NMF solve on one matrix, shared by
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

// Shared-memory floats of one thread group of the register-resident backward
// (rank1_group_bwd): the iterates v_t (P3 each) and u_t, a_u and b_u per
// iteration, and group_sum9's buffer.
__host__ __device__ inline size_t rank1_group_bwd_smem_floats(int P3, int d, int T, int warps) {
  return static_cast<size_t>(T + 1) * (P3 + d) + static_cast<size_t>(T) * (d + 1) + 2 * 9 * static_cast<size_t>(warps);
}

// The register-resident form of rank1_nmf_bwd_block for the bundles' sizes
// (Group<kD, kP>: head_dim 8, patch 8 or 4), the forward's layout: a thread
// group holds one matrix, kRows rows of kD channels a thread, X and G / dX
// in registers, rows moved in 16-byte accesses.  The same sweep as below,
// with every sum over rows a group_sum9 (eight column sums and one scalar,
// one barrier): per forward iteration X v and v.v, for the seed G^T v_T, per
// reverse step X^T abar_v and the V update's bbar.  The iterates v_t (own rows
// only) and the replicated u_t, a_u, b_u are kept in `sm`
// (rank1_group_bwd_smem_floats floats for this group); lane 0 of the group
// writes the replicated ones, which are read only after the seed's barrier.
// HALS's row-wise quotients share their denominator and take one reciprocal
// of it, as the forward kernel's solve does.  The eight updates of u, forward
// and backward, go one to a lane of each eight and are gathered by shuffles,
// where every thread would otherwise divide eight times.
template <typename T, typename Addr, int kD, int kP>
__device__ __forceinline__ void rank1_group_bwd(
    const Addr& win, const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ x_halo,
    const T* __restrict__ g_halo, float* __restrict__ acc, T* __restrict__ out, float* __restrict__ send,
    const float* __restrict__ u0, const float* __restrict__ v0, int mu, int num_iters, int grad_steps, float eps,
    int first, int last, float scale, float* sm, int lane_g) {
  using G = Group<kD, kP>;
  constexpr int R = G::kRows, P3 = G::kP3;
  const int nT = num_iters;
  float* V = sm;                   // [nT + 1][P3]
  float* U = V + (nT + 1) * P3;    // [nT + 1][kD]
  float* AU = U + (nT + 1) * kD;   // [nT][kD]   a_u of iteration t at AU[(t - 1) * kD]
  float* BU = AU + nT * kD;        // [nT]       b_u of iteration t at BU[t - 1]
  float* red = BU + nT;            // [2][kWarps][9]
  int phase = 0;
  // The d = 8 updates of u (forward and backward) are split over each eight
  // lanes, lane dl taking column dl, and gathered back by shuffles.
  const int lane = threadIdx.x & 31, dl = lane & 7, base = lane & ~7;
  auto pick = [dl](const auto& a) {  // a[dl], for an array of at least kD floats
    float r = a[0];
#pragma unroll
    for (int di = 1; di < kD; ++di) r = dl == di ? a[di] : r;
    return r;
  };
  auto gather = [base](float mine, float (&a)[kD]) {
#pragma unroll
    for (int di = 0; di < kD; ++di) a[di] = __shfl_sync(0xffffffffu, mine, base | di);
  };

  float X[R][kD], D[R][kD], v[R], u[kD];  // D holds G, then dX
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int q = lane_g + G::kThreads * k;
    const int64_t o = win.row_offset(q);
    if (Addr::kHalo && o < 0) {
      load8(x_halo + (-1 - o), X[k]);
      load8(g_halo + (-1 - o), D[k]);
    } else {
      load8(x + o, X[k]);
      load8(g + o, D[k]);
    }
    v[k] = v0[q];
    V[q] = v[k];
  }
#pragma unroll
  for (int di = 0; di < kD; ++di) u[di] = u0[di];
  if (lane_g == 0) {
#pragma unroll
    for (int di = 0; di < kD; ++di) U[di] = u[di];
  }

  // The solve, with every iterate kept.
  for (int t = 1; t <= nT; ++t) {
    float s[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) s[i] = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
#pragma unroll
      for (int di = 0; di < kD; ++di) s[di] = fmaf(X[k][di], v[k], s[di]);
      s[8] = fmaf(v[k], v[k], s[8]);
    }
    group_sum9<G::kWarps>(s, red, phase);
    phase ^= 1;
    const float bu = s[8];
    {
      const float uo = pick(u), a = pick(s);
      gather(mu ? fmaf(uo, a, eps) / fmaf(uo, bu, eps) : fmaxf((a + eps) / (bu + eps), 0.f), u);
    }
    float bv = 0.f;
#pragma unroll
    for (int di = 0; di < kD; ++di) bv = fmaf(u[di], u[di], bv);
    const float rv = 1.f / (bv + eps);
    if (lane_g == 0) {
#pragma unroll
      for (int di = 0; di < kD; ++di) {
        AU[(t - 1) * kD + di] = s[di];
        U[t * kD + di] = u[di];
      }
      BU[t - 1] = bu;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float av = 0.f;
#pragma unroll
      for (int di = 0; di < kD; ++di) av = fmaf(X[k][di], u[di], av);
      const float vo = v[k];
      v[k] = mu ? fmaf(vo, av, eps) / fmaf(vo, bv, eps) : fmaxf((av + eps) * rv, 0.f);
      V[t * P3 + lane_g + G::kThreads * k] = v[k];
    }
  }

  // Seed: Y = v_T u_T^T, so ubar = G^T v_T and vbar[q] = G[q] . u_T.
  float ubar, vbar[R];  // ubar of column dl
  {
    float s[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) s[i] = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float sv = 0.f;
#pragma unroll
      for (int di = 0; di < kD; ++di) {
        s[di] = fmaf(D[k][di], v[k], s[di]);
        sv = fmaf(D[k][di], u[di], sv);
        D[k][di] = 0.f;  // G is consumed: D becomes dX
      }
      vbar[k] = sv;
    }
    group_sum9<G::kWarps>(s, red, phase);  // its barrier also publishes U, AU and BU
    phase ^= 1;
    ubar = pick(s);
  }

  for (int t = nT; t > nT - grad_steps; --t) {
    float ut[kD];
    float bv = 0.f;
#pragma unroll
    for (int di = 0; di < kD; ++di) {
      ut[di] = U[t * kD + di];
      bv = fmaf(ut[di], ut[di], bv);
    }
    const float rv = 1.f / (bv + eps);
    // V update backwards, row by row; then X^T abar_v and the b-bar term in one group sum.
    float s[9], av[R];
#pragma unroll
    for (int i = 0; i < 9; ++i) s[i] = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int q = lane_g + G::kThreads * k;
      const float vt = V[t * P3 + q], vp = V[(t - 1) * P3 + q], vb = vbar[k];
      float abar, vprev;
      if (mu) {
        float a_v = 0.f;
#pragma unroll
        for (int di = 0; di < kD; ++di) a_v = fmaf(X[k][di], ut[di], a_v);
        const float den = fmaf(vp, bv, eps);
        const float nbar = vb / den;
        const float dbar = -vb * vt / den;
        abar = nbar * vp;
        s[8] = fmaf(dbar, vp, s[8]);
        vprev = fmaf(nbar, a_v, dbar * bv);
      } else {
        abar = (vt > 0.f ? vb : 0.f) * rv;
        s[8] = fmaf(-abar, vt, s[8]);
        vprev = 0.f;
      }
      av[k] = abar;
      vbar[k] = vprev;
#pragma unroll
      for (int di = 0; di < kD; ++di) {
        D[k][di] = fmaf(abar, ut[di], D[k][di]);
        s[di] = fmaf(X[k][di], abar, s[di]);
      }
    }
    group_sum9<G::kWarps>(s, red, phase);
    phase ^= 1;
    const float bbar_v = s[8];

    // U update backwards, column dl on each lane; then abar_u gathered and the b-bar terms summed.
    const float b_u = BU[t - 1];
    float au[kD], bbar_u;
    {
      const float ut_l = U[t * kD + dl], up_l = U[(t - 1) * kD + dl];
      const float ub = fmaf(2.f * bbar_v, ut_l, ubar + pick(s));
      float au_l;
      if (mu) {
        const float den = fmaf(up_l, b_u, eps);
        const float nbar = ub / den;
        const float dbar = -ub * ut_l / den;
        au_l = nbar * up_l;
        bbar_u = dbar * up_l;
        ubar = fmaf(nbar, AU[(t - 1) * kD + dl], dbar * b_u);
      } else {
        au_l = (ut_l > 0.f ? ub : 0.f) / (b_u + eps);
        bbar_u = -au_l * ut_l;
        ubar = 0.f;
      }
      gather(au_l, au);
      bbar_u += __shfl_xor_sync(0xffffffffu, bbar_u, 1);
      bbar_u += __shfl_xor_sync(0xffffffffu, bbar_u, 2);
      bbar_u += __shfl_xor_sync(0xffffffffu, bbar_u, 4);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float vp = V[(t - 1) * P3 + lane_g + G::kThreads * k];
      float xa_v = 0.f;
#pragma unroll
      for (int di = 0; di < kD; ++di) {
        xa_v = fmaf(X[k][di], au[di], xa_v);
        D[k][di] = fmaf(vp, au[di], D[k][di]);
      }
      vbar[k] += fmaf(2.f * bbar_u, vp, xa_v);
    }
  }

  // dX rows into the sum over shift passes (a slab's halo rows into `send`, in f32).
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int64_t o = win.row_offset(lane_g + G::kThreads * k);
    if (Addr::kHalo && o < 0) {
      store8(send + (-1 - o), D[k]);
    } else {
      store_pass8(acc, out, o, D[k], first, last, scale);
    }
  }
}

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
