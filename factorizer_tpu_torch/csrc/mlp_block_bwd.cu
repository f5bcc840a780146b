// K2, backward: gradients of y = x + fc2(gelu(fc1(LN(x)))) for a cotangent g.
//
// Replaces the Pallas kernels `_bwd_kernel` (factorizer_tpu/ops/pallas/
// mlp_block.py:197, launched at :347) and `_slab_bwd_kernel` (:506, launched
// at :650): two TPU layouts of one function, one kernel here, for C in
// {32, 64, 128, 256, 512}, any H that 32 divides, f32 or bf16 activations, f32
// parameters and f32 gradients.  From the saved x it recomputes, per token
// tile, xhat = (x - mean) rstd, xn = xhat gamma + beta, h = xn W1^T + b1 and
// gel = GELU(h), and emits
//
//   dgel = g W2,  dh = dgel GELU'(h),  dxn = dh W1,
//   dx = g + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),  dxhat = dxn gamma,
//   dW2 = g^T gel,  db2 = sum g,  dW1 = dh^T xn,  db1 = sum dh,
//   dgamma = sum dxn xhat,  dbeta = sum dxn,
//
// with GELU' the exact Phi(h) + h phi(h) (`erff`, `expf`), not the TPU
// kernel's tanh-composite derivative.  The hidden activations never reach
// device memory.
//
// What bounds it on the H100: the five products, 10 C H = 40 C^2 flops per
// token against 3 C activation elements moved.  On tensor cores (TF32) that is
// below the memory time at every width: 0.35 ms of TF32 operations against
// 0.48 ms of f32 bytes at the (2,128^3,32) stage.
//
// What the design does about it:
//   * All five products run on tensor cores with the forward's fragments
//     (`Mma<float>`, mma.cuh): three-pass TF32, m16n8k8, f32 accumulation,
//     about 1e-6 of the f32 result, for both activation dtypes (bf16
//     activations are widened to f32 as they are staged; their bf16 operands
//     would not hold the parameter gradients' band).  h = xn W1^T and
//     dgel = g W2 share one warp tiling, so each thread turns its own h and
//     dgel into gel and dh; dxn = dh W1 is a token-tile product; dW2 += g^T gel
//     and dW1 += dh^T xn reduce over the tile's tokens.  The operands sit in
//     shared memory in f32, each in the layout one of its products reads
//     without bank conflicts (the other reads it transposed, with 2-way
//     conflicts at worst).
//   * A block owns one share of the hidden width (HS columns: all of H at
//     C = 32) and a group of token tiles, and walks the group (a persistent
//     grid).  Its share of W1, W2 and b1 is staged into shared memory once
//     (`cp.async`), and the next tile's x and g load (`cp.async`) behind the
//     current tile's products.  The weight gradients of its share (dW1 rows,
//     dW2 columns, db1) stay in registers across all its tiles and are
//     written once, into the group's partial set.  HS keeps those
//     accumulators at 32 registers a thread (64 at C = 512): 128, 64, 32, 16,
//     16 columns at C = 32 ... 512.
//   * With one share (C = 32) the block finishes each tile: dxn goes through
//     shared memory to the LayerNorm backward, one warp per token, and dx is
//     written; dgamma, dbeta and db2 accumulate per lane.  With several shares
//     each writes its partial dxn in f32, and a second kernel adds the shares
//     in share order, then runs the LayerNorm backward over all tokens.
//   * A third kernel adds the partial sets in set order.  Every sum has a
//     fixed order, so a gradient is the same from run to run.
//   * What it still pays: the three-pass split (each operand element is cut
//     into hi / lo as its fragment is loaded, the products run three times),
//     and at C >= 64 the shares' partial dxn (shares x M x C f32, written
//     and read again) and the LayerNorm recomputed by every share.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using Op = ftt::Mma<float>;

constexpr int kThreads = 256, kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A warp tiling of an M x N product into m16n8 tiles: WM x WN warps, each
// with PM x PN tiles of the same rows and columns (a warp reuses its A
// fragments over its PN columns).  With fewer tiles than warps, warp w < T
// takes tile w and the rest idle.
template <int M, int N>
struct Grid {
  static constexpr int MT = M / 16, NT = N / 8, T = MT * NT;
  static constexpr int WM = T >= kWarps ? (MT < kWarps ? MT : kWarps) : MT;
  static constexpr int WN = T >= kWarps ? kWarps / WM : NT;
  static constexpr int PM = MT / WM, PN = NT / WN;
  static_assert(M % 16 == 0 && N % 8 == 0 && MT % WM == 0 && NT % WN == 0 && WM * WN <= kWarps, "bad grid");
  static __device__ __forceinline__ bool active(int warp) { return warp < WM * WN; }
  static __device__ __forceinline__ int m0(int warp, int i) { return 16 * ((warp % WM) * PM + i); }
  static __device__ __forceinline__ int n0(int warp, int j) { return 8 * ((warp / WM) * PN + j); }
};

// Fragments from shared memory, split into TF32 hi / lo.  kT: the operand is
// stored transposed, element (r, k) at s[k * ld + r] rather than s[r * ld + k].
template <bool kT>
__device__ __forceinline__ float at(const float* s, int ld, int r, int k) {
  return kT ? s[k * ld + r] : s[r * ld + k];
}
template <bool kT>
__device__ __forceinline__ Op::A frag_a(const float* s, int ld, int r0, int k0, int lane) {
  const int r = r0 + (lane >> 2), k = k0 + (lane & 3);
  Op::A f;
  Op::split(at<kT>(s, ld, r, k), f.hi[0], f.lo[0]);
  Op::split(at<kT>(s, ld, r + 8, k), f.hi[1], f.lo[1]);
  Op::split(at<kT>(s, ld, r, k + 4), f.hi[2], f.lo[2]);
  Op::split(at<kT>(s, ld, r + 8, k + 4), f.hi[3], f.lo[3]);
  return f;
}
// B as (column n, depth k): element (n, k) at s[n * ld + k], or at s[k * ld + n] when kT.
template <bool kT>
__device__ __forceinline__ Op::B frag_b(const float* s, int ld, int n0, int k0, int lane) {
  const int n = n0 + (lane >> 2), k = k0 + (lane & 3);
  Op::B f;
  Op::split(at<kT>(s, ld, n, k), f.hi[0], f.lo[0]);
  Op::split(at<kT>(s, ld, n, k + 4), f.hi[1], f.lo[1]);
  return f;
}

// acc += A B over depth K for the warp's tiles of Gd: A (M x K), B given as (N x K).
template <class Gd, int K, bool kTA, bool kTB>
__device__ __forceinline__ void product(float (&acc)[Gd::PM][Gd::PN][4], const float* A, int lda, const float* B,
                                        int ldb, int warp, int lane) {
  if (!Gd::active(warp)) return;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    Op::A a[Gd::PM];
#pragma unroll
    for (int i = 0; i < Gd::PM; ++i) a[i] = frag_a<kTA>(A, lda, Gd::m0(warp, i), k0, lane);
#pragma unroll
    for (int j = 0; j < Gd::PN; ++j) {
      const Op::B b = frag_b<kTB>(B, ldb, Gd::n0(warp, j), k0, lane);
#pragma unroll
      for (int i = 0; i < Gd::PM; ++i) Op::mma(acc[i][j], a[i], b);
    }
  }
}

template <class Gd>
__device__ __forceinline__ void zero(float (&acc)[Gd::PM][Gd::PN][4]) {
#pragma unroll
  for (int i = 0; i < Gd::PM; ++i)
#pragma unroll
    for (int j = 0; j < Gd::PN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Tile shapes per width: TM tokens a tile, HS hidden columns a share.
template <int C_, int TM_, int HS_>
struct Cfg {
  static constexpr int C = C_, TM = TM_, HS = HS_;
  // Whether the hidden width may be one share (H = HS, given H >= C), which
  // then finishes each tile itself; the others keep that path's registers
  // and xhat's shared memory out.
  static constexpr bool kOneShare = HS >= C;
  using G1 = Grid<TM, HS>;  // h, dgel
  // Where h and dgel have fewer tiles than warps (C >= 128), kSplit warps
  // share a tile, each over 1 / kSplit of the depth C, and meet in SPL.
  static constexpr int kSplit = G1::T >= kWarps ? 1 : kWarps / G1::T;
  using G3 = Grid<TM, C>;   // dxn
  using G4 = Grid<C, HS>;   // dW2 (channels x the share's columns)
  using G5 = Grid<HS, C>;   // dW1 (the share's rows x channels)
  // Leading dimensions (floats), each padded for its conflict-free reader.
  static constexpr int LDX = C + 4, LDG = HS + 8, LDD = HS + 4, LDW1 = C + 4, LDW2 = HS + 8;
  static constexpr int W1S = 0, W2S = W1S + HS * LDW1, B1S = W2S + C * LDW2, XN = B1S + HS,
                       GS = XN + TM * LDX, XH = GS + TM * LDX, GEL = XH + (kOneShare ? TM * LDX : 0),
                       DH = GEL + TM * LDG, RS = DH + TM * LDD, RB1 = RS + TM,
                       SPL = RB1 + kWarps * HS, RAW = (SPL + (kSplit > 1 ? kWarps * 32 * 8 : 0) + 3) / 4 * 4;
  // RAW: the next tile's raw x and g, of T
  template <typename T>
  static constexpr size_t bytes() { return sizeof(float) * RAW + 2 * sizeof(T) * TM * C; }
  static_assert(C % 32 == 0 && TM % kWarps == 0 && (kSplit == 1 || (G1::PM == 1 && G1::PN == 1 &&
                kWarps % G1::T == 0 && C % (8 * kSplit) == 0)), "bad tile");
  static_assert(2 * TM * LDX >= 3 * kWarps * C, "the closing reduction reuses XN and GS");
};

// The tile's raw rows [m0, m0 + TM) of x and g into shared memory (x's, then
// g's), 16 bytes a cp.async; rows past M are filled with zeros.  The caller
// commits and waits.
template <typename T, class Cf>
__device__ __forceinline__ void prefetch_tile(const T* __restrict__ x, const T* __restrict__ g, int64_t m0, int64_t M,
                                              T* raw) {
  constexpr int kPerRow = Cf::C * sizeof(T) / 16, kChunks = Cf::TM * kPerRow;
  for (int i = threadIdx.x; i < 2 * kChunks; i += kThreads) {
    const int which = i / kChunks, e = i % kChunks;
    const int64_t row = m0 + e / kPerRow;
    const char* base = reinterpret_cast<const char*>(which ? g : x);
    const char* src = row < M ? base + (m0 * Cf::C) * static_cast<int64_t>(sizeof(T)) + 16 * static_cast<int64_t>(e)
                              : base;
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(reinterpret_cast<char*>(raw + which * Cf::TM * Cf::C) + 16 * e));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(row < M ? 16 : 0));
  }
}

// Per-lane LayerNorm-backward sums of one token: dgamma += dxn xhat, dbeta += dxn, db2 += g.
template <int C>
struct LnSums {
  float gam[C / 32], bet[C / 32], b2[C / 32];
};

// dx of one token from its dxn, xhat, g (lane's channels lane + 32 i) and rstd; adds to the lane's sums.
template <int C>
__device__ __forceinline__ void ln_backward(const float (&dn)[C / 32], const float (&xh)[C / 32],
                                            const float (&gg)[C / 32], float rstd, const float* __restrict__ gamma,
                                            int lane, float (&dx)[C / 32], LnSums<C>& sums) {
  float dxh[C / 32], s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) {
    dxh[i] = dn[i] * gamma[lane + 32 * i];
    s1 += dxh[i];
    s2 += dxh[i] * xh[i];
    sums.gam[i] += dn[i] * xh[i];
    sums.bet[i] += dn[i];
    sums.b2[i] += gg[i];
  }
  s1 = warp_sum(s1) / C;
  s2 = warp_sum(s2) / C;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) dx[i] = gg[i] + rstd * (dxh[i] - s1 - xh[i] * s2);
}

// The block's per-lane sums into its partial set: red holds 3 kWarps C floats;
// the warps' sums are added in warp order.
template <int C>
__device__ __forceinline__ void write_ln_sums(const LnSums<C>& sums, float* red, float* p_gamma, float* p_beta,
                                              float* p_b2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) {
    red[(0 * kWarps + warp) * C + lane + 32 * i] = sums.gam[i];
    red[(1 * kWarps + warp) * C + lane + 32 * i] = sums.bet[i];
    red[(2 * kWarps + warp) * C + lane + 32 * i] = sums.b2[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * C; e += kThreads) {
    const int which = e / C, c = e % C;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[(which * kWarps + w) * C + c];
    (which == 0 ? p_gamma : which == 1 ? p_beta : p_b2)[c] = s;
  }
}

// LayerNorm of one token (x row at `row`, rows at or past M are zeros): the
// lane's channels of x as xhat, and rstd.
template <typename T, int C>
__device__ __forceinline__ float layer_norm_row(const T* __restrict__ x, int64_t row, int64_t M, int lane, float eps,
                                                float (&xh)[C / 32]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) {
    xh[i] = row < M ? ftt::to_float(x[row * C + lane + 32 * i]) : 0.f;
    s += xh[i];
  }
  const float mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) q += (xh[i] - mean) * (xh[i] - mean);
  const float rstd = 1.f / sqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int i = 0; i < C / 32; ++i) xh[i] = (xh[i] - mean) * rstd;
  return rstd;
}

// One partial set, and the final gradients, are laid out flat as
// [dgamma C | dbeta C | dW1 H*C | db1 H | dW2 C*H | db2 C].
__host__ __device__ __forceinline__ int64_t set_floats(int C, int H) {
  return 3 * static_cast<int64_t>(C) + H + 2 * static_cast<int64_t>(H) * C;
}

// Block (group, share): the share's columns [j0, j0 + HS) of the hidden
// width over the group's token tiles tile = group, group + groups, ...
template <typename T, class Cf>
__global__ void __launch_bounds__(kThreads)
prenorm_mlp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
                       float* __restrict__ partials, float* __restrict__ dxn_part, int64_t M, int H, float eps,
                       int shares) {
  constexpr int C = Cf::C, TM = Cf::TM, HS = Cf::HS;
  using G1 = typename Cf::G1;
  using G3 = typename Cf::G3;
  using G4 = typename Cf::G4;
  using G5 = typename Cf::G5;
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem + Cf::W1S;  // [HS][LDW1]  W1's share rows
  float* w2s = smem + Cf::W2S;  // [C][LDW2]   W2's share columns
  float* b1s = smem + Cf::B1S;  // [HS]
  float* xn = smem + Cf::XN;    // [TM][LDX]   normalised tokens; dxn after the products
  float* gs = smem + Cf::GS;    // [TM][LDX]   the cotangent
  float* xhs = smem + Cf::XH;   // [TM][LDX]   xhat
  float* gel = smem + Cf::GEL;  // [TM][LDG]
  float* dhs = smem + Cf::DH;   // [TM][LDD]
  float* rs = smem + Cf::RS;    // [TM]        rstd
  float* rb1 = smem + Cf::RB1;  // [kWarps][HS] db1 per warp row
  T* raw = reinterpret_cast<T*>(smem + Cf::RAW);  // [2][TM][C] the next tile's x and g

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int share = blockIdx.x % shares, group = blockIdx.x / shares, groups = gridDim.x / shares;
  const int j0 = share * HS;
  const bool finish = Cf::kOneShare && shares == 1;  // the LayerNorm backward here, not in a second kernel
  float* mine = partials + group * set_floats(C, H);
  float* p_gamma = mine;
  float* p_beta = p_gamma + C;
  float* p_w1 = p_beta + C;
  float* p_b1 = p_w1 + static_cast<int64_t>(H) * C;
  float* p_w2 = p_b1 + H;
  float* p_b2 = p_w2 + static_cast<int64_t>(H) * C;

  // The share's weights, once: rows [j0, j0 + HS) of W1, columns of W2, 16 bytes a cp.async.
  for (int i = threadIdx.x; i < HS * C / 4; i += kThreads) {
    const int r = i / (C / 4), c = 4 * (i % (C / 4));
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(w1s + r * Cf::LDW1 + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(w1 + static_cast<int64_t>(j0 + r) * C + c));
  }
  for (int i = threadIdx.x; i < C * HS / 4; i += kThreads) {
    const int r = i / (HS / 4), c = 4 * (i % (HS / 4));
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(w2s + r * Cf::LDW2 + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(w2 + static_cast<int64_t>(r) * H + j0 + c));
  }
  const int64_t tiles = (M + TM - 1) / TM;
  if (group < tiles) prefetch_tile<T, Cf>(x, g, group * static_cast<int64_t>(TM), M, raw);
  asm volatile("cp.async.commit_group;");
  for (int j = threadIdx.x; j < HS; j += kThreads) b1s[j] = b1[j0 + j];

  float acc4[G4::PM][G4::PN][4], acc5[G5::PM][G5::PN][4], db1[G1::PN][2];
  zero<G4>(acc4);
  zero<G5>(acc5);
#pragma unroll
  for (int j = 0; j < G1::PN; ++j) db1[j][0] = db1[j][1] = 0.f;
  LnSums<C> sums;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) sums.gam[i] = sums.bet[i] = sums.b2[i] = 0.f;

  for (int64_t tile = group; tile < tiles; tile += groups) {
    const int64_t m0 = tile * TM;
    const int valid = static_cast<int>(M - m0 < TM ? M - m0 : TM);
    asm volatile("cp.async.wait_group 0;");
    __syncthreads();  // this tile's x and g (and, the first time, the weights) are in; the previous tile is consumed

    // LayerNorm, one warp per token; rows past M are zeros, so g = 0 cancels them everywhere.
    for (int m = warp; m < TM; m += kWarps) {
      float xh[C / 32];
      const float rstd = layer_norm_row<T, C>(raw, m, valid, lane, eps, xh);
      if (lane == 0) rs[m] = rstd;
#pragma unroll
      for (int i = 0; i < C / 32; ++i) {
        const int c = lane + 32 * i;
        if (Cf::kOneShare) xhs[m * Cf::LDX + c] = xh[i];
        xn[m * Cf::LDX + c] = m < valid ? xh[i] * gamma[c] + beta[c] : 0.f;
        gs[m * Cf::LDX + c] = ftt::to_float(raw[(TM + m) * C + c]);
      }
    }
    __syncthreads();  // the raw tile is consumed: the next one loads behind this tile's products
    if (tile + groups < tiles) prefetch_tile<T, Cf>(x, g, (tile + groups) * TM, M, raw);
    asm volatile("cp.async.commit_group;");

    // h = xn W1s^T + b1 and dgel = g W2s on one tiling; each thread turns its own into gel and dh.
    {
      float ah[G1::PM][G1::PN][4], ad[G1::PM][G1::PN][4];
      zero<G1>(ah);
      zero<G1>(ad);
      if constexpr (Cf::kSplit == 1) {
        product<G1, C, false, false>(ah, xn, Cf::LDX, w1s, Cf::LDW1, warp, lane);
        product<G1, C, false, true>(ad, gs, Cf::LDX, w2s, Cf::LDW2, warp, lane);
      } else {
        // Warp w takes tile w % T over the depth part w / T; part 0 adds the others' sums in part order.
        constexpr int KP = C / Cf::kSplit;
        const int tile_w = warp % G1::T, k_off = (warp / G1::T) * KP;
        product<G1, KP, false, false>(ah, xn + k_off, Cf::LDX, w1s + k_off, Cf::LDW1, tile_w, lane);
        product<G1, KP, false, true>(ad, gs + k_off, Cf::LDX, w2s + k_off * Cf::LDW2, Cf::LDW2, tile_w, lane);
        float* spl = smem + Cf::SPL;  // [kWarps][32][8]
        if (warp >= G1::T) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            spl[(warp * 32 + lane) * 8 + e] = ah[0][0][e];
            spl[(warp * 32 + lane) * 8 + 4 + e] = ad[0][0][e];
          }
        }
        __syncthreads();
        if (warp < G1::T) {
          for (int part = 1; part < Cf::kSplit; ++part) {
            const float* o = spl + ((part * G1::T + warp) * 32 + lane) * 8;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ah[0][0][e] += o[e];
              ad[0][0][e] += o[4 + e];
            }
          }
        }
      }
      if (G1::active(warp)) {
#pragma unroll
        for (int j = 0; j < G1::PN; ++j) {
          float col_sum[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < G1::PM; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = G1::m0(warp, i) + gq + 8 * (e >> 1), c = G1::n0(warp, j) + 2 * tq + (e & 1);
              const float h = ah[i][j][e] + b1s[c];
              const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
              const float pdf = 0.39894228040143268f * expf(-0.5f * h * h);
              const float d = ad[i][j][e] * (cdf + h * pdf);
              gel[r * Cf::LDG + c] = h * cdf;
              dhs[r * Cf::LDD + c] = d;
              col_sum[e & 1] += d;
            }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float s = col_sum[e];
            s += __shfl_xor_sync(0xffffffffu, s, 4);
            s += __shfl_xor_sync(0xffffffffu, s, 8);
            s += __shfl_xor_sync(0xffffffffu, s, 16);
            db1[j][e] += s;
          }
        }
      }
    }
    __syncthreads();

    // dW2 += g^T gel, dW1 += dh^T xn (depth: the tile's tokens), dxn = dh W1s.
    product<G4, TM, true, true>(acc4, gs, Cf::LDX, gel, Cf::LDG, warp, lane);
    product<G5, TM, true, true>(acc5, dhs, Cf::LDD, xn, Cf::LDX, warp, lane);
    float a3[G3::PM][G3::PN][4];
    zero<G3>(a3);
    product<G3, HS, false, true>(a3, dhs, Cf::LDD, w1s, Cf::LDW1, warp, lane);
    __syncthreads();  // xn is consumed

    // dxn: with one share into xn for the LayerNorm backward below, else this share's partial in f32.
    if (G3::active(warp)) {
#pragma unroll
      for (int i = 0; i < G3::PM; ++i)
#pragma unroll
        for (int j = 0; j < G3::PN; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = G3::m0(warp, i) + gq + 8 * h, c = G3::n0(warp, j) + 2 * tq;
            if (finish) {
              *reinterpret_cast<float2*>(xn + r * Cf::LDX + c) = make_float2(a3[i][j][2 * h], a3[i][j][2 * h + 1]);
            } else if (m0 + r < M) {
              *reinterpret_cast<float2*>(dxn_part + (share * M + m0 + r) * C + c) =
                  make_float2(a3[i][j][2 * h], a3[i][j][2 * h + 1]);
            }
          }
    }
    if (finish) {
      __syncthreads();
      for (int m = warp; m < valid; m += kWarps) {
        const int64_t row = m0 + m;
        float dn[C / 32], xh[C / 32], gg[C / 32], out[C / 32];
#pragma unroll
        for (int i = 0; i < C / 32; ++i) {
          dn[i] = xn[m * Cf::LDX + lane + 32 * i];
          xh[i] = xhs[m * Cf::LDX + lane + 32 * i];
          gg[i] = gs[m * Cf::LDX + lane + 32 * i];
        }
        ln_backward<C>(dn, xh, gg, rs[m], gamma, lane, out, sums);
#pragma unroll
        for (int i = 0; i < C / 32; ++i) dx[row * C + lane + 32 * i] = ftt::from_float<T>(out[i]);
      }
    }
  }

  // The block's partial set: each weight-gradient element from the one thread that holds it.
  if (G4::active(warp)) {
#pragma unroll
    for (int i = 0; i < G4::PM; ++i)
#pragma unroll
      for (int j = 0; j < G4::PN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = G4::m0(warp, i) + gq + 8 * h, c = G4::n0(warp, j) + 2 * tq;
          *reinterpret_cast<float2*>(p_w2 + static_cast<int64_t>(r) * H + j0 + c) =
              make_float2(acc4[i][j][2 * h], acc4[i][j][2 * h + 1]);
        }
  }
  if (G5::active(warp)) {
#pragma unroll
    for (int i = 0; i < G5::PM; ++i)
#pragma unroll
      for (int j = 0; j < G5::PN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = G5::m0(warp, i) + gq + 8 * h, c = G5::n0(warp, j) + 2 * tq;
          *reinterpret_cast<float2*>(p_w1 + static_cast<int64_t>(j0 + r) * C + c) =
              make_float2(acc5[i][j][2 * h], acc5[i][j][2 * h + 1]);
        }
  }
  // db1: the warps that share columns (warp % WM differs) meet in rb1 and are added in that order.
  if (G1::active(warp) && gq == 0) {
#pragma unroll
    for (int j = 0; j < G1::PN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) rb1[(warp % G1::WM) * HS + G1::n0(warp, j) + 2 * tq + e] = db1[j][e];
  }
  __syncthreads();  // rb1 is written; xn, gs and xhs are free for the closing reduction
  for (int j = threadIdx.x; j < HS; j += kThreads) {
    float s = 0.f;
    for (int w = 0; w < G1::WM; ++w) s += rb1[w * HS + j];
    p_b1[j0 + j] = s;
  }
  if (finish) write_ln_sums<C>(sums, xn, p_gamma, p_beta, p_b2);
}

// With several shares: dxn = the shares' partials added in share order, then
// the LayerNorm backward, one warp per token; block b takes the tokens
// b * kWarps + w, stepping by the grid, and writes its sums of dgamma, dbeta
// and db2 as ln_part[b] = [dgamma C | dbeta C | db2 C].
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
prenorm_mlp_bwd_ln_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                          const float* __restrict__ gamma, const float* __restrict__ dxn_part,
                          float* __restrict__ ln_part, int64_t M, float eps, int shares) {
  extern __shared__ __align__(16) float red[];  // [3][kWarps][C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  LnSums<C> sums;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) sums.gam[i] = sums.bet[i] = sums.b2[i] = 0.f;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp; row < M;
       row += static_cast<int64_t>(gridDim.x) * kWarps) {
    float xh[C / 32], dn[C / 32], gg[C / 32], out[C / 32];
    const float rstd = layer_norm_row<T, C>(x, row, M, lane, eps, xh);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      float s = dxn_part[row * C + c];
      for (int k = 1; k < shares; ++k) s += dxn_part[(k * M + row) * C + c];
      dn[i] = s;
      gg[i] = ftt::to_float(g[row * C + c]);
    }
    ln_backward<C>(dn, xh, gg, rstd, gamma, lane, out, sums);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) dx[row * C + lane + 32 * i] = ftt::from_float<T>(out[i]);
  }
  float* mine = ln_part + blockIdx.x * 3 * C;
  write_ln_sums<C>(sums, red, mine, mine + C, mine + 2 * C);
}

// grads[i] = the sum over the groups' partial sets, in group order; with
// ln_sets > 0, dgamma, dbeta and db2 are the sum over ln_part's sets instead.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, const float* __restrict__ ln_part, float* __restrict__ grads,
                    int sets, int ln_sets, int C, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int ln = i < 2 * C ? static_cast<int>(i) : i >= n - C ? static_cast<int>(i - n + 3 * C) : -1;
  float s = 0.f;
  if (ln_sets > 0 && ln >= 0) {
    for (int b = 0; b < ln_sets; ++b) s += ln_part[b * 3 * C + ln];
  } else {
    for (int b = 0; b < sets; ++b) s += partials[b * n + i];
  }
  grads[i] = s;
}

// How the backward splits M tokens: shares of the hidden width, groups of
// token tiles (as many as keep every share's blocks within what the card
// holds at once), and, with several shares, the LayerNorm kernel's blocks;
// and the f32 scratch they need, in floats: the groups' partial sets, then
// the LayerNorm blocks' sums, then (with several shares) the partial dxn.
struct Plan {
  int shares, groups, ln_blocks;
  int64_t ln_at, dxn_at, floats;
};

template <typename T, class Cf>
cudaError_t make_plan(int64_t M, int H, Plan* pl) {
  if (H % Cf::HS || (H == Cf::HS && !Cf::kOneShare)) return cudaErrorInvalidValue;
  const size_t smem = Cf::template bytes<T>();
  auto kernel = prenorm_mlp_bwd_kernel<T, Cf>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  pl->shares = H / Cf::HS;
  const int64_t tiles = (M + Cf::TM - 1) / Cf::TM;
  int64_t want = static_cast<int64_t>(sms) * per_sm / pl->shares;
  want = want < 1 ? 1 : want;
  pl->groups = static_cast<int>(want < tiles ? want : tiles);
  const int64_t rows = (M + kWarps - 1) / kWarps;  // LayerNorm kernel: a warp a token, four blocks an SM
  pl->ln_blocks = pl->shares == 1 ? 0 : static_cast<int>(rows < 4 * sms ? rows : 4 * sms);
  pl->ln_at = pl->groups * set_floats(Cf::C, H);
  pl->dxn_at = (pl->ln_at + 3 * static_cast<int64_t>(Cf::C) * pl->ln_blocks + 3) / 4 * 4;
  pl->floats = pl->dxn_at + (pl->shares == 1 ? 0 : pl->shares * M * Cf::C);
  return cudaSuccess;
}

template <typename T, class Cf>
cudaError_t launch(const void* x, const void* g, void* dx, const float* const* p, float* scratch, int64_t floats,
                   float* grads, int64_t M, int H, float eps, cudaStream_t stream) {
  Plan pl;
  cudaError_t err = make_plan<T, Cf>(M, H, &pl);
  if (err != cudaSuccess) return err;
  if (floats < pl.floats) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  float* dxn_part = pl.shares == 1 ? nullptr : scratch + pl.dxn_at;
  prenorm_mlp_bwd_kernel<T, Cf><<<static_cast<unsigned>(pl.groups * pl.shares), kThreads, Cf::template bytes<T>(),
                                  stream>>>(xt, gt, dxt, p[0], p[1], p[2], p[3], p[4], scratch, dxn_part, M, H, eps,
                                            pl.shares);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (pl.shares > 1) {
    prenorm_mlp_bwd_ln_kernel<T, Cf::C><<<static_cast<unsigned>(pl.ln_blocks), kThreads,
                                          sizeof(float) * 3 * kWarps * Cf::C, stream>>>(
        xt, gt, dxt, p[0], dxn_part, scratch + pl.ln_at, M, eps, pl.shares);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int64_t n = set_floats(Cf::C, H);
  sum_partials_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      scratch, scratch + pl.ln_at, grads, pl.groups, pl.ln_blocks, Cf::C, n);
  return cudaGetLastError();
}

// f(Cf{}) with the configuration for width C and hidden width H:
// Cfg<C, tokens a tile, hidden columns a share>.  The shares keep each
// thread's weight-gradient accumulators at 32 (C <= 256) or 64 registers; an
// H that the share width does not divide takes 32 columns.  Tiles of 16
// tokens at C >= 128 keep the block's shared memory (weights, operands and
// the next tile's x and g) within two blocks an SM, one at C = 512.
template <typename F>
cudaError_t with_cfg(int C, int H, F&& f) {
  switch (C) {
    case 32: return H % 128 == 0 ? f(Cfg<32, 32, 128>{}) : f(Cfg<32, 32, 32>{});
    case 64: return H % 64 == 0 ? f(Cfg<64, 32, 64>{}) : f(Cfg<64, 32, 32>{});
    case 128: return f(Cfg<128, 16, 32>{});
    case 256: return f(Cfg<256, 16, 16>{});
    case 512: return f(Cfg<512, 16, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, void* dx, const float* const* p, float* scratch, int64_t floats,
                     float* grads, int64_t M, int C, int H, float eps, cudaStream_t s) {
  return with_cfg(C, H, [&](auto cfg) {
    return launch<T, decltype(cfg)>(x, g, dx, p, scratch, floats, grads, M, H, eps, s);
  });
}

}  // namespace

// The f32 scratch, in floats, that ftt_prenorm_mlp_bwd needs for M tokens of
// width C and hidden width H on the current device, into *floats.  Returns a
// CUDA status.
extern "C" int ftt_prenorm_mlp_bwd_scratch(long long M, int C, int H, int dtype, long long* floats) {
  if (M <= 0 || H <= 0 || H % 32) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  cudaError_t err;
  if (dtype == ftt::kFloat32) {
    err = with_cfg(C, H, [&](auto cfg) { return make_plan<float, decltype(cfg)>(M, H, &pl); });
  } else if (dtype == ftt::kBFloat16) {
    err = with_cfg(C, H, [&](auto cfg) { return make_plan<__nv_bfloat16, decltype(cfg)>(M, H, &pl); });
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) *floats = pl.floats;
  return static_cast<int>(err);
}

// x, g, dx: (M, C) contiguous, of `dtype`, 16-byte aligned; gamma, beta, b2:
// (C,); w1: (H, C); b1: (H,); w2: (C, H); all parameters f32, w1 and w2
// 16-byte aligned; H a multiple of 32 and at least C.  scratch: `floats` f32,
// at least what ftt_prenorm_mlp_bwd_scratch gives; grads: (n,) f32 with
// n = 3 C + H + 2 H C, laid out as [dgamma | dbeta | dW1 | db1 | dW2 | db2].
// Returns cudaGetLastError().
extern "C" int ftt_prenorm_mlp_bwd(const void* x, const void* g, void* dx, const void* gamma, const void* beta,
                                   const void* w1, const void* b1, const void* w2, const void* b2, void* scratch,
                                   long long floats, void* grads, int dtype, long long M, int C, int H, float eps,
                                   void* stream) {
  (void)b2;  // y is linear in b2: its gradient needs g alone
  const float* params[5] = {static_cast<const float*>(gamma), static_cast<const float*>(beta),
                            static_cast<const float*>(w1), static_cast<const float*>(b1),
                            static_cast<const float*>(w2)};
  auto s = static_cast<cudaStream_t>(stream);
  auto fs = static_cast<float*>(scratch);
  auto fg = static_cast<float*>(grads);
  cudaError_t err;
  if (M <= 0 || H <= 0 || H % 32) {
    err = cudaErrorInvalidValue;
  } else if (dtype == ftt::kFloat32) {
    err = dispatch<float>(x, g, dx, params, fs, floats, fg, M, C, H, eps, s);
  } else if (dtype == ftt::kBFloat16) {
    err = dispatch<__nv_bfloat16>(x, g, dx, params, fs, floats, fg, M, C, H, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
