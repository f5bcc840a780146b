// K1, forward: shifted-window rank-1 NMF on a channels-last volume, in two
// passes.
//
// Replaces the Pallas kernel `_shift_kernel` (factorizer_tpu/ops/pallas/
// windowed_nmf_kernel.py:379), launched per shift by `_shift_pass_fn` (:502)
// under `windowed_nmf_multi` (:652), and the single-shift `_kernel` (:228).
// For each shift s and every (sample, window, head) it solves the d x p^3
// matrix X of the volume rolled by +s: `num_iters` rank-1 HALS or MU updates
// from the shared tables u0 (d) and v0 (p^3).  The output is the mean over
// shifts of u v^T, written back at the un-rolled coordinates.
//
// What bounds it on the H100: memory.  The solve is ~4 flops per element and
// iteration on registers, while every shift reads the whole volume.
//
// What the design does about it:
//   * Pass A (`windowed_nmf_factors_kernel`), one launch over all shifts x
//     windows x heads, solves each matrix and writes only its factors: u (d)
//     to `U (n, B, G, heads, d)` and v (p^3) to `V (n, B, G, heads, p^3)`,
//     G the windows.  That is (d + p^3) / (d p^3) = 12.7 % of the volume per
//     shift at d = p = 8.  Pass B (`windowed_nmf_reconstruct_kernel`) writes
//     each output element once: the mean over shifts of u_s[di] v_s[q_s] at
//     the un-rolled coordinates.  Over four f32 shifts an element costs 16 B
//     of x read, ~2 B of factors written and read and 4 B of y written, where
//     one launch per shift summing into an f32 scratch of the volume's size
//     moved 44 B; the scratch (537 MB at (2,128^3,32)) is gone.
//   * The solve is register-resident (rank1_group_solve in windowed_nmf.cuh):
//     a group of 4 warps holds an 8 x 512 matrix, 4 rows of 8 channels a
//     thread; at p = 4 a warp holds a matrix and a block four.  X v reduces
//     by shuffles (one barrier an iteration), X^T u needs no reduction.
//   * A row's 8 channels are one 16-byte access (bf16) or two (f32), in both
//     passes; the wrapper keeps the tensors 16-byte aligned.
//   * (d, p) = (8, 8) and (8, 4), the bundles' sizes, are compile-time
//     instances; other sizes take a shared-memory solve by a 256-thread block
//     and scalar accesses.
// The shifts travel by value, at most ftt::kMaxShifts a launch.  A call with
// more launches each pass once per group of them: pass A's groups fill their
// own parts of U and V, and pass B's carry the running sum over shifts in an
// f32 scratch of the volume's size from one group to the next.
// Pass B sums the shifts' products in pass order with the roundings of K5's
// `store_pass` chain (windowed_nmf_slab.cu), so K5 on a slab ring equals K1
// on the whole volume bit for bit.  The reads wrap coordinates cyclically, so
// no rolled copy, fold or unfold exists; the TPU kernel's lane packing, wrap
// padding and block-diagonal head mask are Mosaic layout workarounds with no
// counterpart here.
#include "windowed_nmf.cuh"

namespace {

constexpr int kThreads = ftt::kWindowThreads;

// Matrix m of the factors' numbering (shift-major, then sample, window, head)
// as a window of its shift.
template <int kD, int kP>
__device__ ftt::Window<kD, kP> window_of(int64_t m, int64_t per_shift, const ftt::Shifts& sh, int S1, int S2, int S3,
                                         int C, int d, int p) {
  const int s = static_cast<int>(m / per_shift);
  return ftt::Window<kD, kP>(d, p, S1, S2, S3, C, sh.s[s][0], sh.s[s][1], sh.s[s][2], m % per_shift);
}

// Pass A at the compile-time sizes: one thread group per matrix.
template <typename T, int kD, int kP>
__global__ void __launch_bounds__(ftt::Group<kD, kP>::kBlock)
windowed_nmf_factors_kernel(const T* __restrict__ x, float* __restrict__ U, float* __restrict__ V,
                            const float* __restrict__ u0, const float* __restrict__ v0, int S1, int S2, int S3, int C,
                            ftt::Shifts sh, int64_t per_shift, int mu, int num_iters, float eps) {
  using G = ftt::Group<kD, kP>;
  __shared__ float red[G::kGroups][2 * G::kWarps * 9];
  const int group = threadIdx.x / G::kThreads, lane_g = threadIdx.x % G::kThreads;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * G::kGroups + group;
  if (m >= per_shift * sh.n) return;  // a whole group leaves together
  const auto win = window_of<kD, kP>(m, per_shift, sh, S1, S2, S3, C, kD, kP);
  float u[kD], v[G::kRows], X[G::kRows][kD];
  ftt::rank1_group_solve<T, ftt::Window<kD, kP>, kD, kP>(win, x, nullptr, u0, v0, mu, num_iters, eps, red[group],
                                                         lane_g, u, v, X);
  if (lane_g == 0) ftt::store8(U + m * kD, u);
#pragma unroll
  for (int k = 0; k < G::kRows; ++k) V[m * G::kP3 + lane_g + G::kThreads * k] = v[k];
}

// Pass A at any other size: one 256-thread block per matrix, solved in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
windowed_nmf_factors_smem_kernel(const T* __restrict__ x, float* __restrict__ U, float* __restrict__ V,
                                 const float* __restrict__ u0, const float* __restrict__ v0, int S1, int S2, int S3,
                                 int C, int d, int p, ftt::Shifts sh, int64_t per_shift, int mu, int num_iters,
                                 float eps) {
  const int64_t m = blockIdx.x;
  const auto win = window_of<0, 0>(m, per_shift, sh, S1, S2, S3, C, d, p);
  extern __shared__ float smem[];
  ftt::rank1_smem_solve<T, ftt::Window<0, 0>, kThreads>(win, x, nullptr, u0, v0, mu, num_iters, eps, smem);
  const int P3 = win.P3;
  const float* us = ftt::fwd_smem_u(smem, P3, d);
  const float* vs = ftt::fwd_smem_v(smem, P3, d);
  for (int i = threadIdx.x; i < d; i += kThreads) U[m * d + i] = us[i];
  for (int q = threadIdx.x; q < P3; q += kThreads) V[m * P3 + q] = vs[q];
}

// Pass B: one thread per (voxel, head) row of d channels.  For each shift
// the row lies in the window of its rolled coordinate (i + s) mod S; the
// products u_s[di] v_s[q] are summed in shift order, as K5's store_pass
// chain sums them, and scaled by 1/n.  A launch takes one group of shifts:
// all but the first start from the sum in `acc`, all but the last leave it
// there (f32, one row of d a row).
template <typename T, int kD, int kP>
__global__ void __launch_bounds__(kThreads)
windowed_nmf_reconstruct_kernel(const float* __restrict__ U, const float* __restrict__ V, float* __restrict__ acc,
                                T* __restrict__ out, int S1, int S2, int S3, int C, int d_rt, int p_rt,
                                ftt::Shifts sh, int n_rows, int first, int last, float scale) {
  const int d = kD > 0 ? kD : d_rt, p = kP > 0 ? kP : p_rt, P3 = p * p * p, heads = C / d;
  const int G1 = S1 / p, G2 = S2 / p, G3 = S3 / p;
  const int64_t per_shift = static_cast<int64_t>(n_rows / (S1 * S2 * S3)) * G1 * G2 * G3;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; row < n_rows; row += stride) {
    const int r = static_cast<int>(row);  // the entry point keeps the rows below 2^31
    int t = r;
    const int h = t % heads; t /= heads;
    const int i3 = t % S3; t /= S3;
    const int i2 = t % S2; t /= S2;
    const int i1 = t % S1;
    const int b = t / S1;
    // Shift s: the row's window and place in the window at its rolled coordinate.
    auto locate = [&](int s, int64_t& mat, int& q) {
      int r1 = i1 + sh.s[s][0], r2 = i2 + sh.s[s][1], r3 = i3 + sh.s[s][2];
      r1 -= r1 >= S1 ? S1 : 0;
      r2 -= r2 >= S2 ? S2 : 0;
      r3 -= r3 >= S3 ? S3 : 0;
      mat = s * per_shift + ((static_cast<int64_t>(b * G1 + r1 / p) * G2 + r2 / p) * G3 + r3 / p) * heads + h;
      q = ((r1 % p) * p + r2 % p) * p + r3 % p;
    };
    const int64_t at = static_cast<int64_t>(r) * d;
    if constexpr (kD == 8) {
      float sum[8] = {}, u[8];
      if (!first) ftt::load8(acc + at, sum);
      for (int s = 0; s < sh.n; ++s) {
        int64_t mat;
        int q;
        locate(s, mat, q);
        const float vq = V[mat * P3 + q];
        ftt::load8(U + mat * 8, u);
#pragma unroll
        for (int di = 0; di < 8; ++di) {
          const float y = __fmul_rn(u[di], vq);
          sum[di] = first && s == 0 ? y : __fadd_rn(sum[di], y);
        }
      }
      if (!last) {
        ftt::store8(acc + at, sum);
        continue;
      }
#pragma unroll
      for (int di = 0; di < 8; ++di) sum[di] = __fmul_rn(sum[di], scale);
      ftt::store8(out + at, sum);
    } else {
      for (int di = 0; di < d; ++di) {
        float sum = first ? 0.f : acc[at + di];
        for (int s = 0; s < sh.n; ++s) {
          int64_t mat;
          int q;
          locate(s, mat, q);
          const float y = __fmul_rn(U[mat * d + di], V[mat * P3 + q]);
          sum = first && s == 0 ? y : __fadd_rn(sum, y);
        }
        if (last) {
          out[at + di] = ftt::from_float<T>(__fmul_rn(sum, scale));
        } else {
          acc[at + di] = sum;
        }
      }
    }
  }
}

bool compile_time_size(int d, int p) { return d == 8 && (p == 8 || p == 4); }

ftt::Shifts make_shifts(int n_shifts, const int* shifts) {
  ftt::Shifts sh{};
  sh.n = n_shifts;
  for (int s = 0; s < n_shifts; ++s) {
    for (int k = 0; k < 3; ++k) sh.s[s][k] = shifts[3 * s + k];
  }
  return sh;
}

// Shifts [s0, s0 + kMaxShifts) of the n_shifts x 3 table, or as many as are left.
ftt::Shifts shift_group(int s0, int n_shifts, const int* shifts) {
  const int n = n_shifts - s0 < ftt::kMaxShifts ? n_shifts - s0 : ftt::kMaxShifts;
  return make_shifts(n, shifts + 3 * s0);
}

// Matrices of one shift: (sample, window, head).
int64_t matrices_per_shift(int B, int S1, int S2, int S3, int C, int d, int p) {
  return static_cast<int64_t>(B) * (S1 / p) * (S2 / p) * (S3 / p) * (C / d);
}

// Pass A on one group of shifts, into its own part of U and V.
template <typename T>
cudaError_t launch_factors(const void* x, float* U, float* V, const float* u0, const float* v0, int B, int S1, int S2,
                           int S3, int C, int d, int p, const ftt::Shifts& sh, int mu, int num_iters, float eps,
                           cudaStream_t stream) {
  const int64_t per_shift = matrices_per_shift(B, S1, S2, S3, C, d, p);
  const int64_t n_mats = per_shift * sh.n;
  const T* xt = static_cast<const T*>(x);
  if (compile_time_size(d, p)) {
    if (p == 8) {
      using G = ftt::Group<8, 8>;
      windowed_nmf_factors_kernel<T, 8, 8><<<static_cast<unsigned>((n_mats + G::kGroups - 1) / G::kGroups), G::kBlock,
                                             0, stream>>>(xt, U, V, u0, v0, S1, S2, S3, C, sh, per_shift, mu,
                                                          num_iters, eps);
    } else {
      using G = ftt::Group<8, 4>;
      windowed_nmf_factors_kernel<T, 8, 4><<<static_cast<unsigned>((n_mats + G::kGroups - 1) / G::kGroups), G::kBlock,
                                             0, stream>>>(xt, U, V, u0, v0, S1, S2, S3, C, sh, per_shift, mu,
                                                          num_iters, eps);
    }
    return cudaGetLastError();
  }
  const size_t smem = sizeof(float) * ftt::rank1_fwd_smem_floats(p * p * p, d, kThreads);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = windowed_nmf_factors_smem_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(n_mats), kThreads, smem, stream>>>(xt, U, V, u0, v0, S1, S2, S3, C, d, p, sh,
                                                                   per_shift, mu, num_iters, eps);
  return cudaGetLastError();
}

// Pass B: one launch per group of shifts, the sum carried between them in `acc`.
template <typename T>
cudaError_t launch_reconstruct(const float* U, const float* V, float* acc, void* out, int B, int S1, int S2, int S3,
                               int C, int d, int p, int n_shifts, const int* shifts, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * S1 * S2 * S3 * (C / d);
  if (rows >= (int64_t{1} << 31) || (n_shifts > ftt::kMaxShifts && acc == nullptr)) return cudaErrorInvalidValue;
  const int n_rows = static_cast<int>(rows);
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 65535 * 64 ? blocks : 65535 * 64);  // grid-stride beyond
  const int64_t per_shift = matrices_per_shift(B, S1, S2, S3, C, d, p);
  const float scale = 1.f / n_shifts;
  T* o = static_cast<T*>(out);
  for (int s0 = 0; s0 < n_shifts; s0 += ftt::kMaxShifts) {
    const ftt::Shifts sh = shift_group(s0, n_shifts, shifts);
    const float* Ug = U + s0 * per_shift * d;
    const float* Vg = V + s0 * per_shift * p * p * p;
    const int first = s0 == 0, last = s0 + sh.n == n_shifts;
    if (d == 8 && p == 8) {
      windowed_nmf_reconstruct_kernel<T, 8, 8><<<grid, kThreads, 0, stream>>>(Ug, Vg, acc, o, S1, S2, S3, C, d, p, sh,
                                                                              n_rows, first, last, scale);
    } else if (d == 8 && p == 4) {
      windowed_nmf_reconstruct_kernel<T, 8, 4><<<grid, kThreads, 0, stream>>>(Ug, Vg, acc, o, S1, S2, S3, C, d, p, sh,
                                                                              n_rows, first, last, scale);
    } else {
      windowed_nmf_reconstruct_kernel<T, 0, 0><<<grid, kThreads, 0, stream>>>(Ug, Vg, acc, o, S1, S2, S3, C, d, p, sh,
                                                                              n_rows, first, last, scale);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool valid(int B, int S1, int S2, int S3, int C, int d, int p, int n_shifts, const int* shifts) {
  if (B < 1 || d < 1 || d > kThreads || p < 1 || C % d || S1 % p || S2 % p || S3 % p) return false;
  if (n_shifts < 1 || shifts == nullptr) return false;
  for (int i = 0; i < 3 * n_shifts; ++i) {
    if (shifts[i] < 0 || shifts[i] >= p) return false;
  }
  return true;
}

}  // namespace

// Pass A.  x: (B, S1, S2, S3, C) contiguous, of `dtype`, 16-byte aligned;
// shifts: n_shifts x 3 host ints in [0, p); U: (n_shifts, B, G, C/d, d) f32;
// V: (n_shifts, B, G, C/d, p^3) f32, G = (S1/p)(S2/p)(S3/p) windows in
// (g1, g2, g3) order; u0: (d,) f32; v0: (p^3,) f32.  Returns
// cudaGetLastError().
extern "C" int ftt_windowed_nmf_factors(const void* x, void* U, void* V, const void* u0, const void* v0, int dtype,
                                        int B, int S1, int S2, int S3, int C, int d, int p, int n_shifts,
                                        const int* shifts, int mu, int num_iters, float eps, void* stream) {
  if (!valid(B, S1, S2, S3, C, d, p, n_shifts, shifts) || num_iters < 0) return cudaErrorInvalidValue;
  if (dtype != ftt::kFloat32 && dtype != ftt::kBFloat16) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto fu0 = static_cast<const float*>(u0);
  auto fv0 = static_cast<const float*>(v0);
  const int64_t per_shift = matrices_per_shift(B, S1, S2, S3, C, d, p);
  for (int s0 = 0; s0 < n_shifts; s0 += ftt::kMaxShifts) {
    const ftt::Shifts sh = shift_group(s0, n_shifts, shifts);
    float* fU = static_cast<float*>(U) + s0 * per_shift * d;
    float* fV = static_cast<float*>(V) + s0 * per_shift * p * p * p;
    const cudaError_t err =
        dtype == ftt::kFloat32
            ? launch_factors<float>(x, fU, fV, fu0, fv0, B, S1, S2, S3, C, d, p, sh, mu, num_iters, eps, s)
            : launch_factors<__nv_bfloat16>(x, fU, fV, fu0, fv0, B, S1, S2, S3, C, d, p, sh, mu, num_iters, eps, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// Pass B.  U, V: pass A's factors for the same shape and shifts; out:
// (B, S1, S2, S3, C) contiguous, of `dtype`, 16-byte aligned; acc: an f32
// scratch of out's shape when n_shifts > ftt::kMaxShifts, else unused.
// Returns cudaGetLastError().
extern "C" int ftt_windowed_nmf_reconstruct(const void* U, const void* V, void* acc, void* out, int dtype, int B,
                                            int S1, int S2, int S3, int C, int d, int p, int n_shifts,
                                            const int* shifts, void* stream) {
  if (!valid(B, S1, S2, S3, C, d, p, n_shifts, shifts)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto fU = static_cast<const float*>(U);
  auto fV = static_cast<const float*>(V);
  auto facc = static_cast<float*>(acc);
  cudaError_t err;
  if (dtype == ftt::kFloat32) {
    err = launch_reconstruct<float>(fU, fV, facc, out, B, S1, S2, S3, C, d, p, n_shifts, shifts, s);
  } else if (dtype == ftt::kBFloat16) {
    err = launch_reconstruct<__nv_bfloat16>(fU, fV, facc, out, B, S1, S2, S3, C, d, p, n_shifts, shifts, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Both passes in one call: pass A into U, V, then pass B into out, with the
// arguments of the two entry points above.
extern "C" int ftt_windowed_nmf_forward(const void* x, void* U, void* V, void* acc, void* out, const void* u0,
                                        const void* v0, int dtype, int B, int S1, int S2, int S3, int C, int d, int p,
                                        int n_shifts, const int* shifts, int mu, int num_iters, float eps,
                                        void* stream) {
  const int err = ftt_windowed_nmf_factors(x, U, V, u0, v0, dtype, B, S1, S2, S3, C, d, p, n_shifts, shifts, mu,
                                           num_iters, eps, stream);
  if (err != 0) return err;
  return ftt_windowed_nmf_reconstruct(U, V, acc, out, dtype, B, S1, S2, S3, C, d, p, n_shifts, shifts, stream);
}

extern "C" const char* ftt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
