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
//   * A row's 8 channels are one 16-byte access (bf16, f16) or two (f32), in both
//     passes; the wrapper keeps the tensors 16-byte aligned.
//   * (d, p) = (8, 8) and (8, 4), the bundles' sizes, are compile-time
//     instances; other sizes take a shared-memory solve by a 256-thread block
//     and scalar accesses.
// The shifts travel by value, at most ftt::kMaxShifts a launch.  A call with
// more launches each pass once per group of them: pass A's groups fill their
// own parts of U and V, and pass B's carry the running sum over shifts in an
// f32 scratch of the volume's size from one group to the next.
// The kernels live in windowed_nmf_passes.cuh, whose slab mode is K5's
// forward (windowed_nmf_slab.cu): the same solve and the same sum, so K5 on
// a slab ring equals K1 on the whole volume bit for bit.  The reads wrap
// coordinates cyclically, so no rolled copy, fold or unfold exists; the TPU
// kernel's lane packing, wrap padding and block-diagonal head mask are Mosaic
// layout workarounds with no counterpart here.
#include "windowed_nmf_passes.cuh"

namespace {

constexpr ftt::SlabIO kWholeVolume{nullptr, nullptr, 0};

}  // namespace

// Pass A.  x: (B, S1, S2, S3, C) contiguous, of `dtype`, 16-byte aligned;
// shifts: n_shifts x 3 host ints in [0, p); U: (n_shifts, B, G, C/d, d) f32;
// V: (n_shifts, B, G, C/d, p^3) f32, G = (S1/p)(S2/p)(S3/p) windows in
// (g1, g2, g3) order; u0: (d,) f32; v0: (p^3,) f32.  Returns
// cudaGetLastError().
extern "C" int ftt_windowed_nmf_factors(const void* x, void* U, void* V, const void* u0, const void* v0, int dtype,
                                        int B, int S1, int S2, int S3, int C, int d, int p, int n_shifts,
                                        const int* shifts, int mu, int num_iters, float eps, void* stream) {
  return static_cast<int>(ftt::factors_pass<false>(x, kWholeVolume, U, V, u0, v0, dtype, B, S1, S2, S3, C, d, p,
                                                   n_shifts, shifts, mu, num_iters, eps, stream));
}

// Pass B.  U, V: pass A's factors for the same shape and shifts; out:
// (B, S1, S2, S3, C) contiguous, of `dtype`, 16-byte aligned; acc: an f32
// scratch of out's shape when n_shifts > ftt::kMaxShifts, else unused.
// Returns cudaGetLastError().
extern "C" int ftt_windowed_nmf_reconstruct(const void* U, const void* V, void* acc, void* out, int dtype, int B,
                                            int S1, int S2, int S3, int C, int d, int p, int n_shifts,
                                            const int* shifts, void* stream) {
  return static_cast<int>(ftt::reconstruct_pass<false>(U, V, kWholeVolume, acc, out, dtype, B, S1, S2, S3, C, d, p,
                                                       n_shifts, shifts, stream));
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
