// K2, backward: gradients of y = x + fc2(gelu(fc1(LN(x)))) for a cotangent g.
//
// Replaces the Pallas kernels `_bwd_kernel` (factorizer_tpu/ops/pallas/
// mlp_block.py:197, launched at :347) and `_slab_bwd_kernel` (:506, launched
// at :650): two TPU layouts of one function, one kernel here, for C in
// {32, 64, 128, 256, 512}, f32 or bf16 activations, f32 parameters and f32
// arithmetic.  From the saved x it recomputes, per token tile,
// xhat = (x - mean) rstd, xn = xhat gamma + beta, h = xn W1^T + b1 and
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
// What bounds it on the H100: arithmetic.  Five products of 2 C H flops per
// token (two recomputed or applied per direction, two weight-gradient outer
// products) make 10 C H = 40 C^2 flops per token against 3 C activation
// elements moved: 172 GFLOP, 2.6 ms on the f32 CUDA cores, against 0.5 ms of
// memory traffic for the (2,128^3,32) stage.
//
// What the design does about it, and about the sums over every token that the
// parameter gradients are: the TPU kernel adds into revisited output blocks
// because its grid runs in order; CUDA blocks run concurrently.  So the grid
// is capped and persistent: a block walks over its token tiles and adds each
// tile's share of the six parameter gradients into its own partial set in a
// scratch (each address has one owner thread, so the adds need neither atomics
// nor barriers and mostly hit L1/L2), and a second kernel sums the partial sets
// in block order.  The order of every sum is fixed, so a gradient is the same
// from run to run.  Per tile the hidden width is walked in chunks, as in the
// forward: h and dgel share one pass over C, dxn accumulates in registers, and
// the two outer products reduce over the tile's tokens in shared memory.  The
// products run as CUDA-core FMAs; tensor cores are left for a later change.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int C, int TM, int HC, int TY>
struct Tile {
  static constexpr int TX = kThreads / TY;
  static constexpr int RM = TM / TY;    // token rows per thread
  static constexpr int RN1 = HC / TX;   // hidden columns per thread
  static constexpr int RN2 = C / TX;    // channels per thread
  static constexpr int LDX = TM + 1;    // odd strides: conflict-free shared-memory access
  static constexpr int LDW1 = HC + 1;
  static constexpr int LDW2 = C + 1;
  static constexpr int LDG = TM + 1;
  static constexpr size_t kSmemFloats =
      3 * static_cast<size_t>(C) * LDX + C * LDW1 + HC * LDW2 + 2 * HC * LDG + HC + TM;
  static_assert(TM % TY == 0 && HC % TX == 0 && C % TX == 0 && C % TY == 0 && HC % TY == 0 &&
                    C % 32 == 0 && HC <= kThreads,
                "bad tile");
};

// dst[(ty + TY i) * ld_dst + tx + TX r] (+)= sum_m A[(ty + TY i) * lda + m] * B[(tx + TX r) * ldb + m]:
// an outer product reduced over the tile's TM tokens, RA x RB outputs per
// thread.  Every address of `dst` belongs to one thread of one block.
template <int RA, int RB, int TY, int TX, int TM>
__device__ __forceinline__ void token_outer(const float* A, int lda, const float* B, int ldb,
                                            float* dst, int ld_dst, bool first, int ty, int tx) {
  float acc[RA][RB];
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[i][r] = 0.f;
  for (int m = 0; m < TM; ++m) {
    float a[RA], b[RB];
#pragma unroll
    for (int i = 0; i < RA; ++i) a[i] = A[(ty + TY * i) * lda + m];
#pragma unroll
    for (int r = 0; r < RB; ++r) b[r] = B[(tx + TX * r) * ldb + m];
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[i][r] = fmaf(a[i], b[r], acc[i][r]);
  }
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float* p = dst + static_cast<int64_t>(ty + TY * i) * ld_dst + tx + TX * r;
      *p = first ? acc[i][r] : *p + acc[i][r];
    }
}

// One partial set, and the final gradients, are laid out flat as
// [dgamma C | dbeta C | dW1 H*C | db1 H | dW2 C*H | db2 C].
template <typename T, int C, int TM, int HC, int TY>
__global__ void __launch_bounds__(kThreads)
prenorm_mlp_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const float* __restrict__ w1, const float* __restrict__ b1,
                       const float* __restrict__ w2, float* partials, int64_t M, int H, float eps) {
  using Tl = Tile<C, TM, HC, TY>;
  constexpr int TX = Tl::TX, RM = Tl::RM, RN1 = Tl::RN1, RN2 = Tl::RN2;
  extern __shared__ float smem[];
  float* xh = smem;                    // [C][LDX]   xhat, channel-major
  float* xn = xh + C * Tl::LDX;        // [C][LDX]   normalised tokens; dxn after the chunks
  float* gs = xn + C * Tl::LDX;        // [C][LDX]   the cotangent
  float* w1s = gs + C * Tl::LDX;       // [C][LDW1]  W1 chunk, channel-major
  float* w2s = w1s + C * Tl::LDW1;     // [HC][LDW2] W2 chunk, hidden-major
  float* ge = w2s + HC * Tl::LDW2;     // [HC][LDG]  gelu(h) chunk
  float* dh = ge + HC * Tl::LDG;       // [HC][LDG]  dh chunk
  float* b1s = dh + HC * Tl::LDG;      // [HC]
  float* rs = b1s + HC;                // [TM]       rstd per token

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t HCtot = static_cast<int64_t>(H) * C;
  float* mine = partials + static_cast<int64_t>(blockIdx.x) * (3 * C + H + 2 * HCtot);
  float* p_gamma = mine;
  float* p_beta = p_gamma + C;
  float* p_w1 = p_beta + C;
  float* p_b1 = p_w1 + HCtot;
  float* p_w2 = p_b1 + H;
  float* p_b2 = p_w2 + HCtot;

  const int64_t n_tiles = (M + TM - 1) / TM;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == blockIdx.x;  // the tile that starts this block's partial sums
    const int64_t m0 = tile * TM;
    __syncthreads();  // the previous tile is consumed

    // LayerNorm over C, one warp per token, as in the forward; rows past M are zeros.
    for (int m = warp; m < TM; m += kThreads / 32) {
      const int64_t row = m0 + m;
      float vals[C / 32];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < C / 32; ++i) {
        vals[i] = row < M ? ftt::to_float(x[row * C + lane + 32 * i]) : 0.f;
        s += vals[i];
      }
      const float mean = warp_sum(s) / C;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < C / 32; ++i) q += (vals[i] - mean) * (vals[i] - mean);
      const float rstd = 1.f / sqrtf(warp_sum(q) / C + eps);
      if (lane == 0) rs[m] = rstd;
#pragma unroll
      for (int i = 0; i < C / 32; ++i) {
        const int c = lane + 32 * i;
        const float xhat = (vals[i] - mean) * rstd;
        xh[c * Tl::LDX + m] = xhat;
        xn[c * Tl::LDX + m] = xhat * gamma[c] + beta[c];
        gs[c * Tl::LDX + m] = row < M ? ftt::to_float(g[row * C + c]) : 0.f;
      }
    }

    float acc2[RM][RN2];  // dxn
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int r = 0; r < RN2; ++r) acc2[i][r] = 0.f;

    for (int j0 = 0; j0 < H; j0 += HC) {
      __syncthreads();  // the previous chunk is consumed; the staged tile is visible
      for (int e = tid; e < HC * C; e += kThreads) {
        const int j = e / C, k = e % C;
        w1s[k * Tl::LDW1 + j] = w1[static_cast<int64_t>(j0 + j) * C + k];
      }
      for (int e = tid; e < HC * C; e += kThreads) {
        const int n = e / HC, j = e % HC;
        w2s[j * Tl::LDW2 + n] = w2[static_cast<int64_t>(n) * H + j0 + j];
      }
      if (tid < HC) b1s[tid] = b1[j0 + tid];
      __syncthreads();

      // h = xn W1c^T + b1c and dgel = g W2c in one pass over C.
      float acc1[RM][RN1], accd[RM][RN1];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int r = 0; r < RN1; ++r) {
          acc1[i][r] = b1s[tx + TX * r];
          accd[i][r] = 0.f;
        }
      for (int k = 0; k < C; ++k) {
        float a[RM], gg[RM], bw[RN1], cw[RN1];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          a[i] = xn[k * Tl::LDX + ty + TY * i];
          gg[i] = gs[k * Tl::LDX + ty + TY * i];
        }
#pragma unroll
        for (int r = 0; r < RN1; ++r) {
          bw[r] = w1s[k * Tl::LDW1 + tx + TX * r];
          cw[r] = w2s[(tx + TX * r) * Tl::LDW2 + k];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int r = 0; r < RN1; ++r) {
            acc1[i][r] = fmaf(a[i], bw[r], acc1[i][r]);
            accd[i][r] = fmaf(gg[i], cw[r], accd[i][r]);
          }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int r = 0; r < RN1; ++r) {
          const float h = acc1[i][r];
          const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
          const float pdf = 0.39894228040143268f * expf(-0.5f * h * h);
          const int at = (tx + TX * r) * Tl::LDG + ty + TY * i;
          ge[at] = h * cdf;
          dh[at] = accd[i][r] * (cdf + h * pdf);
        }
      __syncthreads();

      // dxn += dh W1c
      for (int j = 0; j < HC; ++j) {
        float a[RM], bw[RN2];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = dh[j * Tl::LDG + ty + TY * i];
#pragma unroll
        for (int r = 0; r < RN2; ++r) bw[r] = w1s[(tx + TX * r) * Tl::LDW1 + j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int r = 0; r < RN2; ++r) acc2[i][r] = fmaf(a[i], bw[r], acc2[i][r]);
      }
      // dW2[:, chunk] += g^T gel (rows: channels, columns: hidden) and
      // dW1[chunk, :] += dh^T xn (rows: hidden, columns: channels).
      token_outer<C / TY, RN1, TY, TX, TM>(gs, Tl::LDX, ge, Tl::LDG, p_w2 + j0, H, first, ty, tx);
      token_outer<HC / TY, RN2, TY, TX, TM>(dh, Tl::LDG, xn, Tl::LDX, p_w1 + static_cast<int64_t>(j0) * C,
                                            C, first, ty, tx);
      if (tid < HC) {
        float s = 0.f;
        for (int m = 0; m < TM; ++m) s += dh[tid * Tl::LDG + m];
        p_b1[j0 + tid] = first ? s : p_b1[j0 + tid] + s;
      }
    }

    __syncthreads();  // xn is consumed; it now takes dxn
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int r = 0; r < RN2; ++r) xn[(tx + TX * r) * Tl::LDX + ty + TY * i] = acc2[i][r];
    __syncthreads();

    for (int c = tid; c < C; c += kThreads) {
      float sg = 0.f, sgam = 0.f, sbet = 0.f;
      for (int m = 0; m < TM; ++m) {
        const float dn = xn[c * Tl::LDX + m];
        sg += gs[c * Tl::LDX + m];
        sgam += dn * xh[c * Tl::LDX + m];
        sbet += dn;
      }
      p_b2[c] = first ? sg : p_b2[c] + sg;
      p_gamma[c] = first ? sgam : p_gamma[c] + sgam;
      p_beta[c] = first ? sbet : p_beta[c] + sbet;
    }

    // dx = g + LN^T(dxn), one warp per token.
    for (int m = warp; m < TM; m += kThreads / 32) {
      const int64_t row = m0 + m;
      if (row >= M) continue;  // uniform over the warp
      float dxh[C / 32];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < C / 32; ++i) {
        const int c = lane + 32 * i;
        dxh[i] = xn[c * Tl::LDX + m] * gamma[c];
        s1 += dxh[i];
        s2 += dxh[i] * xh[c * Tl::LDX + m];
      }
      s1 = warp_sum(s1) / C;
      s2 = warp_sum(s2) / C;
      const float rstd = rs[m];
#pragma unroll
      for (int i = 0; i < C / 32; ++i) {
        const int c = lane + 32 * i;
        const float v = gs[c * Tl::LDX + m] + rstd * (dxh[i] - s1 - xh[c * Tl::LDX + m] * s2);
        dx[row * C + c] = ftt::from_float<T>(v);
      }
    }
  }
}

// grads[i] = sum over the blocks' partial sets, in block order.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, float* __restrict__ grads, int blocks, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partials[b * n + i];
  grads[i] = s;
}

template <typename T, int C, int TM, int HC, int TY>
cudaError_t launch(const void* x, const void* g, void* dx, const float* const* p, float* partials,
                   float* grads, int64_t M, int H, float eps, int blocks, cudaStream_t stream) {
  if (H % HC || blocks > (M + TM - 1) / TM) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * Tile<C, TM, HC, TY>::kSmemFloats;
  auto kernel = prenorm_mlp_bwd_kernel<T, C, TM, HC, TY>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx), p[0], p[1], p[2], p[3],
      p[4], partials, M, H, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = 3 * static_cast<int64_t>(C) + H + 2 * static_cast<int64_t>(H) * C;
  sum_partials_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      partials, grads, blocks, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, void* dx, const float* const* p, float* partials,
                     float* grads, int64_t M, int C, int H, float eps, int blocks, cudaStream_t s) {
  switch (C) {  // <T, C, tokens per block, hidden chunk, thread rows>, the forward's tiles
    case 32: return launch<T, 32, 128, 32, 32>(x, g, dx, p, partials, grads, M, H, eps, blocks, s);
    case 64: return launch<T, 64, 64, 64, 16>(x, g, dx, p, partials, grads, M, H, eps, blocks, s);
    case 128: return launch<T, 128, 64, 64, 16>(x, g, dx, p, partials, grads, M, H, eps, blocks, s);
    case 256: return launch<T, 256, 32, 32, 16>(x, g, dx, p, partials, grads, M, H, eps, blocks, s);
    case 512: return launch<T, 512, 16, 16, 16>(x, g, dx, p, partials, grads, M, H, eps, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, g, dx: (M, C) contiguous, of `dtype`; gamma, beta, b2: (C,); w1: (H, C);
// b1: (H,); w2: (C, H); all parameters f32.  partials: (blocks, n) f32 scratch
// and grads: (n,) f32 with n = 3 C + H + 2 H C, laid out as
// [dgamma | dbeta | dW1 | db1 | dW2 | db2]; blocks is the grid, at most the
// number of token tiles.  Returns cudaGetLastError().
extern "C" int ftt_prenorm_mlp_bwd(const void* x, const void* g, void* dx, const void* gamma,
                                   const void* beta, const void* w1, const void* b1, const void* w2,
                                   const void* b2, void* partials, void* grads, int dtype,
                                   long long M, int C, int H, float eps, int blocks, void* stream) {
  (void)b2;  // y is linear in b2: its gradient needs g alone
  const float* params[5] = {static_cast<const float*>(gamma), static_cast<const float*>(beta),
                            static_cast<const float*>(w1), static_cast<const float*>(b1),
                            static_cast<const float*>(w2)};
  auto s = static_cast<cudaStream_t>(stream);
  auto fp = static_cast<float*>(partials);
  auto fg = static_cast<float*>(grads);
  cudaError_t err;
  if (M <= 0 || H <= 0 || blocks <= 0) {
    err = cudaErrorInvalidValue;
  } else if (dtype == ftt::kFloat32) {
    err = dispatch<float>(x, g, dx, params, fp, fg, M, C, H, eps, blocks, s);
  } else if (dtype == ftt::kBFloat16) {
    err = dispatch<__nv_bfloat16>(x, g, dx, params, fp, fg, M, C, H, eps, blocks, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
