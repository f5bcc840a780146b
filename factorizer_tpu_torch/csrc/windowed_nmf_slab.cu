// K5, forward: the windowed rank-1 NMF on one slab of a volume that is cut
// along its first spatial axis over a ring of devices, in K1's two passes.
//
// Replaces `windowed_nmf_multi_spatial` (factorizer_tpu/ops/pallas/
// windowed_sharded.py:112), whose `_local_forward` (:66) pads each slab in
// front with the left neighbour's last p rows (`_pad12_halo` :49, one
// `ppermute` for all shifts), wraps dims 2 and 3 by a padded copy, runs K1's
// Pallas pass (`_shift_pass_fn`, windowed_nmf_kernel.py:502 -> `pallas_call`
// :521) on the padded slab per shift, rolls the result back along dim 2 and
// sends the first s1 rows of it back to the left neighbour (`_roll_back_dim1`
// :57).  The transport stays outside the kernels there and here
// (torch.distributed, between the two passes).
//
// A slab holds its own L rows, a multiple of the patch (S1 / n on equal
// slabs; the slabs of a ring may hold unequal L).  For the shift (s1, s2, s3)
// the slab's first window row covers the rows [-s1, p - s1): its rows below 0
// are the left neighbour's.  So, with H the largest s1 of the call:
//   * one exchange forward along the ring brings the left neighbour's last H
//     rows (the halo, B x H x S2 x S3 x C of the slab's dtype); a shift of s1
//     reads its last s1 rows (H = 6 serves the bundles' shifts 2, 4 and 6);
//   * pass A (`ftt_windowed_nmf_slab_factors`), one launch over every shift's
//     windows of the slab, is K1's (windowed_nmf_passes.cuh) with window rows
//     below 0 read from the halo.  It writes U and V as K1 does and, for each
//     shift with s1 > 0 and each matrix of the slab's first window row, u and
//     v's entries on the rows a1 < s1 into the routed factors (f32,
//     `route_record`);
//   * one exchange backward along the ring carries the routed factors;
//   * pass B (`ftt_windowed_nmf_slab_reconstruct`), one launch, writes each
//     element of the slab once, the mean over shifts in pass order with K1's
//     roundings (__fmul_rn, __fadd_rn); for its last s1 rows under shift s it
//     reads the factors that arrived from the right neighbour.
// Those factors are the right neighbour's solve of the very windows that K1
// solves on the whole volume, and pass B sums in K1's order, so the output
// equals K1's bit for bit, in bf16 and f16 too.  With no shift that moves
// rows nothing is exchanged and the passes are K1's on the slab.
//
// What bounds it on the H100: memory, as K1.  Per shift pass A reads the slab
// (and the halo's s1 / L more), pass B writes it once; the factors add
// (d + p^3) / (d p^3) of the slab per shift, and the routed factors
// (d + s1 p^2) / (d p^3) of it.  What the design does about it: K1's, with no
// f32 scratch of the slab's size, no per-shift halo copies, no routed rows of
// the output and no tail launch: 2 exchanges and 2 launches a mixer.
#include "windowed_nmf_passes.cuh"

// Pass A on one slab.  x: (B, L, S2, S3, C) contiguous, of `dtype`, 16-byte
// aligned; halo: (B, H, S2, S3, C) of `dtype`, the left neighbour's last H
// rows (unused when H == 0); shifts: n_shifts x 3 host ints in [0, p), every
// s1 <= H < p; U, V: K1's factors of the slab (ftt_windowed_nmf_factors);
// route: the routed factors, for each shift with s1 > 0 in order, one record
// of d + s1 p^2 f32 per matrix (sample, g2, g3, head) of the slab's first
// window row (unused when H == 0); u0: (d,) f32; v0: (p^3,) f32.
extern "C" int ftt_windowed_nmf_slab_factors(const void* x, const void* halo, void* U, void* V, void* route,
                                             const void* u0, const void* v0, int dtype, int B, int L, int S2, int S3,
                                             int C, int d, int p, int H, int n_shifts, const int* shifts, int mu,
                                             int num_iters, float eps, void* stream) {
  const ftt::SlabIO slab{halo, static_cast<float*>(route), H};
  return static_cast<int>(ftt::factors_pass<true>(x, slab, U, V, u0, v0, dtype, B, L, S2, S3, C, d, p, n_shifts,
                                                  shifts, mu, num_iters, eps, stream));
}

// Pass B on one slab.  U, V: pass A's factors of this slab; route: the routed
// factors that arrived from the right neighbour, laid out as pass A writes
// them (unused when no shift moves rows); acc: an f32 scratch of out's shape
// when n_shifts > ftt::kMaxShifts, else unused; out: (B, L, S2, S3, C) of
// `dtype`, 16-byte aligned.
extern "C" int ftt_windowed_nmf_slab_reconstruct(const void* U, const void* V, const void* route, void* acc, void* out,
                                                 int dtype, int B, int L, int S2, int S3, int C, int d, int p,
                                                 int n_shifts, const int* shifts, void* stream) {
  int H = 0;
  for (int s = 0; shifts != nullptr && s < n_shifts; ++s) H = shifts[3 * s] > H ? shifts[3 * s] : H;
  const ftt::SlabIO slab{nullptr, const_cast<float*>(static_cast<const float*>(route)), H};
  return static_cast<int>(ftt::reconstruct_pass<true>(U, V, slab, acc, out, dtype, B, L, S2, S3, C, d, p, n_shifts,
                                                      shifts, stream));
}
