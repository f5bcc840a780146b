// K1's two forward passes (design and bound: windowed_nmf.cu's note), on a
// whole volume (K1) or, with kSlab, on one slab of a volume cut along S1 over
// a ring of devices (K5, windowed_nmf_slab.cu's note).  Pass A solves every
// shift's windows and keeps only their factors; pass B writes each output
// element once, the mean over shifts of the factors' product.
#pragma once

#include "windowed_nmf.cuh"

namespace ftt {

// K5's slab mode; K1 passes {nullptr, nullptr, 0}.  `halo` (B, H, S2, S3, C),
// of the slab's dtype, holds the left neighbour's last H rows, H the largest
// s1 of the call: pass A reads a shift's window rows below 0 there.  `route`
// holds the routed factors (route_record): pass A writes them for the left
// neighbour, pass B reads those that arrived from the right one.
struct SlabIO {
  const void* halo;
  float* route;
  int H;
};

// The floats of one matrix's routed factors under a shift of s1 rows: u (d),
// then v's entries on the window rows a1 < s1 (s1 p^2), which are the left
// neighbour's; none when s1 = 0.  Each record is a multiple of 16 bytes at the
// compile-time sizes, so u moves in 16-byte accesses.
__host__ __device__ inline int64_t route_record(int s1, int d, int p) {
  return s1 ? d + static_cast<int64_t>(s1) * p * p : 0;
}

// Where shift s of a group of shifts starts in `route`: the records of the
// shifts before it, one for each of the row_mats matrices (sample, g2, g3,
// head) of the slab's first window row.
__host__ __device__ inline int64_t route_slot(const Shifts& sh, int s, int64_t row_mats, int d, int p) {
  int64_t off = 0;
  for (int k = 0; k < s; ++k) off += route_record(sh.s[k][0], d, p);
  return off * row_mats;
}

// Matrices of one window row of one shift: (g2, g3, head).
__host__ __device__ inline int64_t row_matrices(int S2, int S3, int C, int d, int p) {
  return static_cast<int64_t>(S2 / p) * (S3 / p) * (C / d);
}

// The routed record of matrix mm (numbered within its shift: sample, window,
// head) of shift s, or null where the shift moves no rows or the matrix is not
// in the slab's first window row.
__device__ __forceinline__ float* route_of(float* route, const Shifts& sh, int s, int64_t mm, int64_t per_shift,
                                           int S1, int S2, int S3, int C, int d, int p) {
  const int s1 = sh.s[s][0];
  const int64_t per_row = row_matrices(S2, S3, C, d, p), G1 = S1 / p;
  if (s1 == 0 || (mm / per_row) % G1 != 0) return nullptr;
  const int64_t i = mm / (per_row * G1) * per_row + mm % per_row;
  return route + route_slot(sh, s, per_shift / G1, d, p) + i * route_record(s1, d, p);
}

// Pass A at the compile-time sizes: one thread group per matrix (Group<kD, kP>);
// matrices are numbered shift-major, then sample, window, head.
template <typename T, int kD, int kP, bool kSlab>
__global__ void __launch_bounds__(Group<kD, kP>::kBlock)
windowed_nmf_factors_kernel(const T* __restrict__ x, SlabIO slab, float* __restrict__ U, float* __restrict__ V,
                            const float* __restrict__ u0, const float* __restrict__ v0, int S1, int S2, int S3, int C,
                            Shifts sh, int64_t per_shift, int mu, int num_iters, float eps) {
  using G = Group<kD, kP>;
  using Win = Window<kD, kP, kSlab>;
  __shared__ float red[G::kGroups][2 * G::kWarps * 9];
  const int group = threadIdx.x / G::kThreads, lane_g = threadIdx.x % G::kThreads;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * G::kGroups + group;
  if (m >= per_shift * sh.n) return;  // a whole group leaves together
  const int s = static_cast<int>(m / per_shift);
  const Win win(kD, kP, S1, S2, S3, C, sh.s[s][0], sh.s[s][1], sh.s[s][2], m % per_shift, slab.H);
  float u[kD], v[G::kRows], X[G::kRows][kD];
  rank1_group_solve<T, Win, kD, kP>(win, x, static_cast<const T*>(slab.halo), u0, v0, mu, num_iters, eps, red[group],
                                    lane_g, u, v, X);
  if (lane_g == 0) store8(U + m * kD, u);
#pragma unroll
  for (int k = 0; k < G::kRows; ++k) V[m * G::kP3 + lane_g + G::kThreads * k] = v[k];
  if constexpr (kSlab) {
    float* rec = route_of(slab.route, sh, s, m % per_shift, per_shift, S1, S2, S3, C, kD, kP);
    if (rec != nullptr) {
      if (lane_g == 0) store8(rec, u);
      const int n_v = sh.s[s][0] * kP * kP;
#pragma unroll
      for (int k = 0; k < G::kRows; ++k) {
        const int q = lane_g + G::kThreads * k;
        if (q < n_v) rec[kD + q] = v[k];
      }
    }
  }
}

// Pass A at any other size: one 256-thread block per matrix, solved in shared memory.
template <typename T, bool kSlab>
__global__ void __launch_bounds__(kWindowThreads)
windowed_nmf_factors_smem_kernel(const T* __restrict__ x, SlabIO slab, float* __restrict__ U, float* __restrict__ V,
                                 const float* __restrict__ u0, const float* __restrict__ v0, int S1, int S2, int S3,
                                 int C, int d, int p, Shifts sh, int64_t per_shift, int mu, int num_iters, float eps) {
  using Win = Window<0, 0, kSlab>;
  const int64_t m = blockIdx.x;
  const int s = static_cast<int>(m / per_shift);
  const Win win(d, p, S1, S2, S3, C, sh.s[s][0], sh.s[s][1], sh.s[s][2], m % per_shift, slab.H);
  extern __shared__ float smem[];
  rank1_smem_solve<T, Win, kWindowThreads>(win, x, static_cast<const T*>(slab.halo), u0, v0, mu, num_iters, eps, smem);
  const int P3 = win.P3;
  const float* us = fwd_smem_u(smem, P3, d);
  const float* vs = fwd_smem_v(smem, P3, d);
  for (int i = threadIdx.x; i < d; i += kWindowThreads) U[m * d + i] = us[i];
  for (int q = threadIdx.x; q < P3; q += kWindowThreads) V[m * P3 + q] = vs[q];
  if constexpr (kSlab) {
    float* rec = route_of(slab.route, sh, s, m % per_shift, per_shift, S1, S2, S3, C, d, p);
    if (rec != nullptr) {
      for (int i = threadIdx.x; i < d; i += kWindowThreads) rec[i] = us[i];
      for (int q = threadIdx.x; q < sh.s[s][0] * p * p; q += kWindowThreads) rec[d + q] = vs[q];
    }
  }
}

// Pass B: one thread per (voxel, head) row of d channels.  For each shift
// the row lies in the window of its rolled coordinate (i + s) mod S; the
// products u_s[di] v_s[q] are rounded by __fmul_rn, summed by __fadd_rn in
// shift order (K1 bwd's store_pass chain rounds the same way) and scaled by
// 1/n.  A launch takes one group of shifts: all but the first start from the
// sum in `acc`, all but the last leave it there (f32, one row of d a row).
// On a slab (kSlab) dim 1 does not wrap: a rolled row at or past S1 lies in
// the right neighbour's first window row, whose factors are in `route`.
template <typename T, int kD, int kP, bool kSlab>
__global__ void __launch_bounds__(kWindowThreads)
windowed_nmf_reconstruct_kernel(const float* __restrict__ U, const float* __restrict__ V,
                                const float* __restrict__ route, float* __restrict__ acc, T* __restrict__ out, int S1,
                                int S2, int S3, int C, int d_rt, int p_rt, Shifts sh, int n_rows, int first, int last,
                                float scale) {
  const int d = kD > 0 ? kD : d_rt, p = kP > 0 ? kP : p_rt, P3 = p * p * p, heads = C / d;
  const int G1 = S1 / p, G2 = S2 / p, G3 = S3 / p;
  const int64_t per_row = static_cast<int64_t>(G2) * G3 * heads;
  const int64_t per_shift = static_cast<int64_t>(n_rows / (S1 * S2 * S3 * heads)) * G1 * per_row;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWindowThreads;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWindowThreads + threadIdx.x; row < n_rows; row += stride) {
    const int r = static_cast<int>(row);  // the entry point keeps the rows below 2^31
    int t = r;
    const int h = t % heads; t /= heads;
    const int i3 = t % S3; t /= S3;
    const int i2 = t % S2; t /= S2;
    const int i1 = t % S1;
    const int b = t / S1;
    // Shift s: the factors of the row's window at its rolled coordinate (u into `us`) and v at the row's place.
    auto factors = [&](int s, const float*& us) -> float {
      int r1 = i1 + sh.s[s][0], r2 = i2 + sh.s[s][1], r3 = i3 + sh.s[s][2];
      r2 -= r2 >= S2 ? S2 : 0;
      r3 -= r3 >= S3 ? S3 : 0;
      const int64_t w = (static_cast<int64_t>(r2 / p) * G3 + r3 / p) * heads + h;
      const int q23 = (r2 % p) * p + r3 % p;
      if constexpr (kSlab) {
        if (r1 >= S1) {
          const float* rec = route + route_slot(sh, s, per_shift / G1, d, p) +
                             (b * per_row + w) * route_record(sh.s[s][0], d, p);
          us = rec;
          return rec[d + (r1 - S1) * p * p + q23];
        }
      } else {
        r1 -= r1 >= S1 ? S1 : 0;
      }
      const int64_t mat = s * per_shift + (static_cast<int64_t>(b) * G1 + r1 / p) * per_row + w;
      us = U + mat * d;
      return V[mat * P3 + (r1 % p) * p * p + q23];
    };
    const int64_t at = static_cast<int64_t>(r) * d;
    if constexpr (kD == 8) {
      float sum[8] = {}, u[8];
      if (!first) load8(acc + at, sum);
      for (int s = 0; s < sh.n; ++s) {
        const float* us;
        const float vq = factors(s, us);
        load8(us, u);
#pragma unroll
        for (int di = 0; di < 8; ++di) {
          const float y = __fmul_rn(u[di], vq);
          sum[di] = first && s == 0 ? y : __fadd_rn(sum[di], y);
        }
      }
      if (!last) {
        store8(acc + at, sum);
        continue;
      }
#pragma unroll
      for (int di = 0; di < 8; ++di) sum[di] = __fmul_rn(sum[di], scale);
      store8(out + at, sum);
    } else {
      for (int di = 0; di < d; ++di) {
        float sum = first ? 0.f : acc[at + di];
        for (int s = 0; s < sh.n; ++s) {
          const float* us;
          const float vq = factors(s, us);
          const float y = __fmul_rn(us[di], vq);
          sum = first && s == 0 ? y : __fadd_rn(sum, y);
        }
        if (last) {
          out[at + di] = from_float<T>(__fmul_rn(sum, scale));
        } else {
          acc[at + di] = sum;
        }
      }
    }
  }
}

inline bool compile_time_size(int d, int p) { return d == 8 && (p == 8 || p == 4); }

// Shifts [s0, s0 + kMaxShifts) of the n_shifts x 3 table, or as many as are left.
inline Shifts shift_group(int s0, int n_shifts, const int* shifts) {
  Shifts sh{};
  sh.n = n_shifts - s0 < kMaxShifts ? n_shifts - s0 : kMaxShifts;
  for (int s = 0; s < sh.n; ++s) {
    for (int k = 0; k < 3; ++k) sh.s[s][k] = shifts[3 * (s0 + s) + k];
  }
  return sh;
}

// Matrices of one shift: (sample, window, head).
inline int64_t matrices_per_shift(int B, int S1, int S2, int S3, int C, int d, int p) {
  return static_cast<int64_t>(B) * (S1 / p) * row_matrices(S2, S3, C, d, p);
}

// The slab's IO for the group of shifts that starts at s0: its routed factors
// start after the records of the shifts before it.
inline SlabIO slab_group(SlabIO slab, const int* shifts, int s0, int64_t row_mats, int d, int p) {
  for (int k = 0; k < s0 && slab.route != nullptr; ++k) slab.route += route_record(shifts[3 * k], d, p) * row_mats;
  return slab;
}

// Whether the shapes and shifts are ones the passes take; on a slab (kSlab),
// H must cover every shift's s1 and the buffers must be there where H > 0.
template <bool kSlab>
bool passes_valid(int B, int S1, int S2, int S3, int C, int d, int p, int n_shifts, const int* shifts,
                  const SlabIO& slab, bool halo_needed) {
  if (B < 1 || d < 1 || d > kWindowThreads || p < 1 || C % d || S1 % p || S2 % p || S3 % p) return false;
  if (n_shifts < 1 || shifts == nullptr) return false;
  if (kSlab && (slab.H < 0 || slab.H >= p ||
                (slab.H > 0 && (slab.route == nullptr || (halo_needed && slab.halo == nullptr))))) {
    return false;
  }
  for (int i = 0; i < 3 * n_shifts; ++i) {
    if (shifts[i] < 0 || shifts[i] >= p || (kSlab && i % 3 == 0 && shifts[i] > slab.H)) return false;
  }
  return true;
}

// Pass A on one group of shifts, into its own part of U and V (and of the route).
template <typename T, bool kSlab>
cudaError_t launch_factors(const void* x, SlabIO slab, float* U, float* V, const float* u0, const float* v0, int B,
                           int S1, int S2, int S3, int C, int d, int p, const Shifts& sh, int mu, int num_iters,
                           float eps, cudaStream_t stream) {
  const int64_t per_shift = matrices_per_shift(B, S1, S2, S3, C, d, p);
  const int64_t n_mats = per_shift * sh.n;
  const T* xt = static_cast<const T*>(x);
  if (compile_time_size(d, p)) {
    if (p == 8) {
      using G = Group<8, 8>;
      windowed_nmf_factors_kernel<T, 8, 8, kSlab><<<static_cast<unsigned>((n_mats + G::kGroups - 1) / G::kGroups),
                                                    G::kBlock, 0, stream>>>(xt, slab, U, V, u0, v0, S1, S2, S3, C, sh,
                                                                            per_shift, mu, num_iters, eps);
    } else {
      using G = Group<8, 4>;
      windowed_nmf_factors_kernel<T, 8, 4, kSlab><<<static_cast<unsigned>((n_mats + G::kGroups - 1) / G::kGroups),
                                                    G::kBlock, 0, stream>>>(xt, slab, U, V, u0, v0, S1, S2, S3, C, sh,
                                                                            per_shift, mu, num_iters, eps);
    }
    return cudaGetLastError();
  }
  const size_t smem = sizeof(float) * rank1_fwd_smem_floats(p * p * p, d, kWindowThreads);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = windowed_nmf_factors_smem_kernel<T, kSlab>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(n_mats), kWindowThreads, smem, stream>>>(xt, slab, U, V, u0, v0, S1, S2, S3, C, d, p,
                                                                          sh, per_shift, mu, num_iters, eps);
  return cudaGetLastError();
}

// Pass A over all shifts, one launch per group of kMaxShifts.  x: (B, S1, S2,
// S3, C) of `dtype`; U: (n_shifts, B, G, C/d, d) f32; V: (n_shifts, B, G, C/d,
// p^3) f32, G the windows in (g1, g2, g3) order.
template <bool kSlab>
cudaError_t factors_pass(const void* x, SlabIO slab, void* U, void* V, const void* u0, const void* v0, int dtype,
                         int B, int S1, int S2, int S3, int C, int d, int p, int n_shifts, const int* shifts, int mu,
                         int num_iters, float eps, void* stream) {
  if (!passes_valid<kSlab>(B, S1, S2, S3, C, d, p, n_shifts, shifts, slab, true) || num_iters < 0) {
    return cudaErrorInvalidValue;
  }
  if (dtype != kFloat32 && dtype != kBFloat16 && dtype != kFloat16) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto fu0 = static_cast<const float*>(u0);
  auto fv0 = static_cast<const float*>(v0);
  const int64_t per_shift = matrices_per_shift(B, S1, S2, S3, C, d, p);
  for (int s0 = 0; s0 < n_shifts; s0 += kMaxShifts) {
    const Shifts sh = shift_group(s0, n_shifts, shifts);
    const SlabIO io = slab_group(slab, shifts, s0, per_shift / (S1 / p), d, p);
    float* fU = static_cast<float*>(U) + s0 * per_shift * d;
    float* fV = static_cast<float*>(V) + s0 * per_shift * p * p * p;
    const cudaError_t err =
        dtype == kFloat32
            ? launch_factors<float, kSlab>(x, io, fU, fV, fu0, fv0, B, S1, S2, S3, C, d, p, sh, mu, num_iters, eps, s)
        : dtype == kBFloat16
            ? launch_factors<__nv_bfloat16, kSlab>(x, io, fU, fV, fu0, fv0, B, S1, S2, S3, C, d, p, sh, mu, num_iters,
                                                   eps, s)
            : launch_factors<__half, kSlab>(x, io, fU, fV, fu0, fv0, B, S1, S2, S3, C, d, p, sh, mu, num_iters, eps, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Pass B: one launch per group of shifts, the sum carried between them in `acc`.
template <typename T, bool kSlab>
cudaError_t launch_reconstruct(const float* U, const float* V, SlabIO slab, float* acc, void* out, int B, int S1,
                               int S2, int S3, int C, int d, int p, int n_shifts, const int* shifts,
                               cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * S1 * S2 * S3 * (C / d);
  if (rows >= (int64_t{1} << 31) || (n_shifts > kMaxShifts && acc == nullptr)) return cudaErrorInvalidValue;
  const int n_rows = static_cast<int>(rows);
  const int64_t blocks = (rows + kWindowThreads - 1) / kWindowThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 65535 * 64 ? blocks : 65535 * 64);  // grid-stride beyond
  const int64_t per_shift = matrices_per_shift(B, S1, S2, S3, C, d, p);
  const float scale = 1.f / n_shifts;
  T* o = static_cast<T*>(out);
  for (int s0 = 0; s0 < n_shifts; s0 += kMaxShifts) {
    const Shifts sh = shift_group(s0, n_shifts, shifts);
    const float* Ug = U + s0 * per_shift * d;
    const float* Vg = V + s0 * per_shift * p * p * p;
    const float* route = slab_group(slab, shifts, s0, per_shift / (S1 / p), d, p).route;
    const int first = s0 == 0, last = s0 + sh.n == n_shifts;
    if (d == 8 && p == 8) {
      windowed_nmf_reconstruct_kernel<T, 8, 8, kSlab><<<grid, kWindowThreads, 0, stream>>>(
          Ug, Vg, route, acc, o, S1, S2, S3, C, d, p, sh, n_rows, first, last, scale);
    } else if (d == 8 && p == 4) {
      windowed_nmf_reconstruct_kernel<T, 8, 4, kSlab><<<grid, kWindowThreads, 0, stream>>>(
          Ug, Vg, route, acc, o, S1, S2, S3, C, d, p, sh, n_rows, first, last, scale);
    } else {
      windowed_nmf_reconstruct_kernel<T, 0, 0, kSlab><<<grid, kWindowThreads, 0, stream>>>(
          Ug, Vg, route, acc, o, S1, S2, S3, C, d, p, sh, n_rows, first, last, scale);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Pass B over all shifts.  U, V: pass A's factors for the same shape and
// shifts; out: (B, S1, S2, S3, C) of `dtype`; acc: an f32 scratch of out's
// shape when n_shifts > kMaxShifts, else unused.
template <bool kSlab>
cudaError_t reconstruct_pass(const void* U, const void* V, SlabIO slab, void* acc, void* out, int dtype, int B,
                             int S1, int S2, int S3, int C, int d, int p, int n_shifts, const int* shifts,
                             void* stream) {
  if (!passes_valid<kSlab>(B, S1, S2, S3, C, d, p, n_shifts, shifts, slab, false)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto fU = static_cast<const float*>(U);
  auto fV = static_cast<const float*>(V);
  auto facc = static_cast<float*>(acc);
  if (dtype == kFloat32) {
    return launch_reconstruct<float, kSlab>(fU, fV, slab, facc, out, B, S1, S2, S3, C, d, p, n_shifts, shifts, s);
  }
  if (dtype == kBFloat16) {
    return launch_reconstruct<__nv_bfloat16, kSlab>(fU, fV, slab, facc, out, B, S1, S2, S3, C, d, p, n_shifts,
                                                     shifts, s);
  }
  if (dtype == kFloat16) {
    return launch_reconstruct<__half, kSlab>(fU, fV, slab, facc, out, B, S1, S2, S3, C, d, p, n_shifts, shifts, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace ftt
