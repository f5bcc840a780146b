// K2, forward: fused pre-norm MLP residual, y = x + fc2(gelu(fc1(LN(x)))).
//
// Replaces the Pallas kernels `_fwd_kernel` (factorizer_tpu/ops/pallas/
// mlp_block.py:183, launched by `_fwd_fn` at :293) and `_slab_fwd_kernel`
// (:493, launched by `_slab_fwd_fn` at :596) under `fused_prenorm_mlp` (:735).
// The two TPU kernels compute the same function in two TPU layouts; this one
// kernel serves every block tail of the model: C in {32, 64, 128, 256, 512},
// any H that 32 divides (the bundles' H = 4C, the module's default 2C), f32,
// bf16 or f16 activations, f32 parameters, a two-pass f32 LayerNorm
// and the exact erf GELU (`erff`), as the unfused module computes them.
//
// What bounds it on the H100: the two products, 4 C H = 16 C^2 flops per
// token against 2 C activation elements moved (the hidden activations never
// leave the block).  On tensor cores that is below the memory time at every
// width in bf16; in f32 the three-pass split triples the products.
//
// What the design does about it:
//   * Both products run on tensor cores (`mma.sync`).  bf16 activations: bf16
//     operands (the normalised tokens, GELU's output and the weights rounded
//     once, the weights into a bf16 copy ahead of the kernel) with f32
//     accumulation, m16n8k16, the JAX kernel's own numerics.  f16 activations
//     take the same path with f16 operands (one pass, as bf16).
//     f32 activations: three-pass TF32, m16n8k8, each operand split into
//     hi = tf32(v) and lo = tf32(v - hi) (cut, not rounded) and the product taken as
//     lo*hi + hi*lo + hi*hi, which keeps ~22 bits where one TF32 pass keeps
//     11.  LayerNorm statistics, bias, GELU and the residual are f32.
//   * Weights are staged once per block.  At C <= 64 and H = 4C all of W1 and
//     W2 fit in shared memory (f32: 32 / 128 KB; bf16 and f16 half that): a persistent grid of
//     as many blocks as fit walks over tiles of 64 tokens, with the next
//     tile's x in flight (`cp.async`) behind the current tile's products.
//     Else (C >= 128, where tokens are few and weights large) a block owns one token
//     tile and one share of the hidden width (`plan_shares` picks how many
//     shares: as many as still fit one wave of blocks, so that the 8^3
//     bottleneck's 1024 tokens fill the card and no more); it
//     streams its share of the weights through shared memory in chunks
//     (`cp.async`, the next chunk's loads behind this chunk's products) and
//     writes a partial y to an f32 scratch, and a second kernel adds the
//     shares in a fixed order, then the residual and b2.  A result is the
//     same from run to run.
//   * Per chunk of the hidden width: h = LN(x) W1^T + b1 on tensor cores, GELU
//     into shared memory, and y += GELU(h) W2^T into registers.  Eight warps
//     tile the token rows 16 at a time and split the columns.  Shared-memory
//     rows are padded so that every fragment load is free of bank conflicts.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using ftt::Mma;

constexpr int kThreads = 256, kWarps = kThreads / 32;

// Tile shapes per width: TM tokens a tile, HC hidden columns a chunk;
// kResident: all of W1 and W2 (H = 4C) stay in shared memory (C <= 64), else
// a block streams its share of any H that HC divides.  Warps tile the rows 16
// at a time (WM of them) and split the columns WN ways; a block has W_ warps.
template <int C_, int TM_, int HC_, bool kResident_, int W_ = kWarps>
struct Cfg {
  static constexpr int C = C_, TM = TM_, HC = HC_, H = 4 * C_;
  static constexpr bool kResident = kResident_;
  static constexpr int kWarps = W_, kThreads = 32 * W_;
  static constexpr int WM = TM / 16, WN = kWarps / WM;
  static constexpr int NT1 = HC / (8 * WN), NT2 = C / (8 * WN);
  static_assert(TM % 16 == 0 && kWarps % WM == 0 && NT1 >= 1 && NT2 >= 1 && HC % (8 * WN) == 0 &&
                C % (8 * WN) == 0 && H % HC == 0 && C % 32 == 0, "bad tile");

  template <typename T> struct Smem {
    using S = typename Mma<T>::S;
    static constexpr int P = Mma<T>::kPad;
    static constexpr int LDX = C + P, LDG = HC + P, LDW1 = C + P, LDW2 = (kResident ? H : HC) + P;
    static constexpr int W1_ROWS = kResident ? H : HC;
    static constexpr size_t XN = 0;
    static constexpr size_t G = XN + sizeof(S) * TM * LDX;
    static constexpr size_t W1 = G + sizeof(S) * TM * LDG;
    static constexpr size_t W2 = W1 + sizeof(S) * W1_ROWS * LDW1;
    static constexpr size_t XR = (W2 + sizeof(S) * C * LDW2 + 15) / 16 * 16;  // raw x, two tiles (resident)
    static constexpr size_t BYTES = XR + (kResident ? 2 * sizeof(T) * TM * C : 0);
  };
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu(float h) { return 0.5f * h * (1.f + erff(h * 0.70710678118654752f)); }

// LayerNorm of the tile's TM tokens from `src` (rows of C values of T, the
// tile's first row at src), one warp per token: mean, then the mean of
// centred squares; rows at or past `valid` are zero.
template <typename T, class Cf, typename S>
__device__ __forceinline__ void layer_norm(const T* src, int valid, S* xn, const float* __restrict__ gamma,
                                           const float* __restrict__ beta, float eps) {
  constexpr int C = Cf::C, LDX = Cf::template Smem<T>::LDX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < Cf::TM; m += Cf::kWarps) {
    float vals[C / 32];
    if (m >= valid) {
#pragma unroll
      for (int i = 0; i < C / 32; ++i) xn[m * LDX + lane + 32 * i] = ftt::from_float<S>(0.f);
      continue;
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      vals[i] = ftt::to_float(src[m * C + lane + 32 * i]);
      s += vals[i];
    }
    const float mean = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) q += (vals[i] - mean) * (vals[i] - mean);
    const float rstd = 1.f / sqrtf(warp_sum(q) / C + eps);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      xn[m * LDX + c] = ftt::from_float<S>((vals[i] - mean) * rstd * gamma[c] + beta[c]);
    }
  }
}

// Rows [r0, r0 + rows) of the matrix w (leading dim ldw), columns
// [c0, c0 + cols), into shared memory at dst (leading dim ldd), 16 bytes a
// cp.async; the caller commits the group.
template <int kT, typename S>
__device__ __forceinline__ void stage(const S* __restrict__ w, int ldw, int r0, int rows, int c0, int cols, S* dst,
                                      int ldd) {
  constexpr int kPer = 16 / sizeof(S);
  const int per_row = cols / kPer;
  for (int i = threadIdx.x; i < rows * per_row; i += kT) {
    const int r = i / per_row, c = kPer * (i % per_row);
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ldd + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(w + static_cast<int64_t>(r0 + r) * ldw + c0 + c));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;"); }
template <int N> __device__ __forceinline__ void wait_groups() { asm volatile("cp.async.wait_group %0;" ::"n"(N)); }

// The two products of one chunk of HC hidden columns for the tile in `xn`;
// the caller puts a barrier between them and before the next chunk.
// gemm1_gelu: h = xn W1c^T + b1c and GELU(h) into `gs`; w1c holds the
// chunk's HC rows of W1 (rows of C).
template <typename T, class Cf, typename S>
__device__ __forceinline__ void gemm1_gelu(const S* xn, S* gs, const S* w1c, const float* __restrict__ b1c) {
  using Op = Mma<T>;
  using Sm = typename Cf::template Smem<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = 16 * (warp % Cf::WM), wn = warp / Cf::WM;
  const int g = lane >> 2, t = lane & 3;
  // The depth C is long and NT1 short: independent sums per pass and per
  // half of the depth (kHalves) keep several mma chains in flight.
  constexpr int kHalves = Cf::NT1 == 1 ? 2 : 1, kP = Op::kPasses;
  float cp[kHalves][Cf::NT1][kP][4];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int n = 0; n < Cf::NT1; ++n)
#pragma unroll
      for (int q = 0; q < kP; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) cp[h][n][q][i] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < Cf::C; k0 += kHalves * Op::kK) {
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const auto a = Op::load_a(xn, Sm::LDX, row0, k0 + h * Op::kK, lane);
#pragma unroll
      for (int n = 0; n < Cf::NT1; ++n) {
        Op::mma_passes(cp[h][n], a, Op::load_b(w1c, Sm::LDW1, (wn * Cf::NT1 + n) * 8, k0 + h * Op::kK, lane));
      }
    }
  }
  float c1[Cf::NT1][4];
#pragma unroll
  for (int n = 0; n < Cf::NT1; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int q = 0; q < kP; ++q) v += cp[h][n][q][i];
      c1[n][i] = v;
    }
#pragma unroll
  for (int n = 0; n < Cf::NT1; ++n) {
    const int j = (wn * Cf::NT1 + n) * 8 + 2 * t;
    const float bj0 = b1c[j], bj1 = b1c[j + 1];
    Op::store2(gs + (row0 + g) * Sm::LDG + j, gelu(c1[n][0] + bj0), gelu(c1[n][1] + bj1));
    Op::store2(gs + (row0 + g + 8) * Sm::LDG + j, gelu(c1[n][2] + bj0), gelu(c1[n][3] + bj1));
  }
}

// gemm2: acc += GELU(h) W2c^T; w2c holds C rows whose columns
// [k_off, k_off + HC) are the chunk's columns of W2.
template <typename T, class Cf, typename S>
__device__ __forceinline__ void gemm2(const S* gs, const S* w2c, int k_off, float (&acc)[Cf::NT2][4]) {
  using Op = Mma<T>;
  using Sm = typename Cf::template Smem<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = 16 * (warp % Cf::WM), wn = warp / Cf::WM;
#pragma unroll 4
  for (int k0 = 0; k0 < Cf::HC; k0 += Op::kK) {
    const auto a = Op::load_a(gs, Sm::LDG, row0, k0, lane);
#pragma unroll
    for (int n = 0; n < Cf::NT2; ++n) {
      Op::mma(acc[n], a, Op::load_b(w2c, Sm::LDW2, (wn * Cf::NT2 + n) * 8, k_off + k0, lane));
    }
  }
}

// The tile's output rows: y = x + (acc + b2) with x from `res` (the tile's
// first row, rows of C), or, with shares of the hidden width, acc into the
// share's partial sums.
template <typename T, class Cf>
__device__ __forceinline__ void epilogue(const float (&acc)[Cf::NT2][4], const T* res, T* __restrict__ y,
                                         float* __restrict__ partial, const float* __restrict__ b2, int64_t m0,
                                         int valid) {
  constexpr int C = Cf::C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = 16 * (warp % Cf::WM), wn = warp / Cf::WM;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < Cf::NT2; ++n) {
    const int c = (wn * Cf::NT2 + n) * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + g + 8 * half;
      if (r >= valid) continue;
      const float a0 = acc[n][2 * half], a1 = acc[n][2 * half + 1];
      if (partial != nullptr) {
        *reinterpret_cast<float2*>(partial + (m0 + r) * C + c) = make_float2(a0, a1);
      } else {
        Mma<T>::store2(y + (m0 + r) * C + c, ftt::to_float(res[r * C + c]) + (a0 + b2[c]),
                   ftt::to_float(res[r * C + c + 1]) + (a1 + b2[c + 1]));
      }
    }
  }
}

// The tile's raw x into shared memory, 16 bytes a copy; rows past M read nothing and are left as they are.
template <typename T, class Cf>
__device__ __forceinline__ void prefetch_tile(const T* __restrict__ x, int64_t m0, int64_t M, T* dst) {
  constexpr int kChunks = Cf::TM * Cf::C * sizeof(T) / 16, kPerRow = Cf::C * sizeof(T) / 16;
  for (int i = threadIdx.x; i < kChunks; i += Cf::kThreads) {
    const int64_t row = m0 + i / kPerRow;
    const char* src = reinterpret_cast<const char*>(x + m0 * Cf::C) + 16 * static_cast<int64_t>(i);
    const unsigned dst_addr = static_cast<unsigned>(__cvta_generic_to_shared(reinterpret_cast<char*>(dst) + 16 * i));
    const int bytes = row < M ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst_addr), "l"(row < M ? src : reinterpret_cast<const char*>(x)), "r"(bytes));
  }
  commit();
}

// w1, w2: the weights in the operand type (f32, or the bf16 or f16 copy the entry point makes).
template <typename T, class Cf>
__global__ void __launch_bounds__(Cf::kThreads)
prenorm_mlp_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, float* __restrict__ partial,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const typename Mma<T>::S* __restrict__ w1, const float* __restrict__ b1,
                       const typename Mma<T>::S* __restrict__ w2, const float* __restrict__ b2, int64_t M, int H_rt,
                       float eps, int splits) {
  using Sm = typename Cf::template Smem<T>;
  using S = typename Sm::S;
  constexpr int C = Cf::C, TM = Cf::TM, HC = Cf::HC;
  extern __shared__ __align__(16) unsigned char smem[];
  S* xn = reinterpret_cast<S*>(smem + Sm::XN);
  S* gs = reinterpret_cast<S*>(smem + Sm::G);
  S* w1s = reinterpret_cast<S*>(smem + Sm::W1);
  S* w2s = reinterpret_cast<S*>(smem + Sm::W2);
  const int64_t tiles = (M + TM - 1) / TM;
  float acc[Cf::NT2][4];

  if constexpr (Cf::kResident) {
    constexpr int H = Cf::H;
    T* xr = reinterpret_cast<T*>(smem + Sm::XR);  // two tiles of raw x
    int64_t tile = blockIdx.x;
    stage<Cf::kThreads>(w1, C, 0, H, 0, C, w1s, Sm::LDW1);
    stage<Cf::kThreads>(w2, H, 0, C, 0, H, w2s, Sm::LDW2);
    commit();
    if (tile < tiles) prefetch_tile<T, Cf>(x, tile * TM, M, xr);
    for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
      T* cur = xr + (it & 1) * TM * C;
      __syncthreads();  // the other buffer's last reader (the previous epilogue) is done
      const int64_t next = tile + gridDim.x;
      if (next < tiles) {
        prefetch_tile<T, Cf>(x, next * TM, M, xr + ((it + 1) & 1) * TM * C);
        wait_groups<1>();
      } else {
        wait_groups<0>();
      }
      __syncthreads();  // this tile's x (and, the first time, the weights) are visible
      const int64_t m0 = tile * TM;
      const int valid = static_cast<int>(M - m0 < TM ? M - m0 : TM);
      layer_norm<T, Cf>(cur, valid, xn, gamma, beta, eps);
#pragma unroll
      for (int n = 0; n < Cf::NT2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
      for (int j0 = 0; j0 < H; j0 += HC) {
        __syncthreads();  // xn written; the previous chunk's second product has read gs
        gemm1_gelu<T, Cf>(xn, gs, w1s + j0 * Sm::LDW1, b1 + j0);
        __syncthreads();
        gemm2<T, Cf>(gs, w2s, j0, acc);
      }
      epilogue<T, Cf>(acc, cur, y, nullptr, b2, m0, valid);
    }
  } else {
    // One tile, one share of the hidden width, its weights streamed in
    // chunks: the next chunk's W1 loads behind this chunk's second product,
    // its W2 behind the next chunk's first.
    const int64_t tile = blockIdx.x / splits;
    const int H = H_rt, share = blockIdx.x % splits, hs = H / splits, j_begin = share * hs, j_end = j_begin + hs;
    const int64_t m0 = tile * TM;
    const int valid = static_cast<int>(M - m0 < TM ? M - m0 : TM);
    stage<Cf::kThreads>(w1, C, j_begin, HC, 0, C, w1s, Sm::LDW1);
    commit();
    stage<Cf::kThreads>(w2, H, 0, C, j_begin, HC, w2s, Sm::LDW2);
    commit();
    layer_norm<T, Cf>(x + m0 * C, valid, xn, gamma, beta, eps);
#pragma unroll
    for (int n = 0; n < Cf::NT2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
    for (int j0 = j_begin; j0 < j_end; j0 += HC) {
      wait_groups<1>();  // this chunk's W1 (its W2 may still be in flight)
      __syncthreads();   // W1 and xn visible; the previous second product is done with gs
      gemm1_gelu<T, Cf>(xn, gs, w1s, b1 + j0);
      __syncthreads();   // gs visible; W1's buffer free
      if (j0 + HC < j_end) stage<Cf::kThreads>(w1, C, j0 + HC, HC, 0, C, w1s, Sm::LDW1);
      commit();
      wait_groups<1>();  // this chunk's W2
      __syncthreads();
      gemm2<T, Cf>(gs, w2s, 0, acc);
      __syncthreads();   // W2's buffer and gs free
      if (j0 + HC < j_end) stage<Cf::kThreads>(w2, H, 0, C, j0 + HC, HC, w2s, Sm::LDW2);
      commit();
    }
    wait_groups<0>();
    epilogue<T, Cf>(acc, x + m0 * C, y, splits > 1 ? partial + static_cast<int64_t>(share) * M * C : nullptr, b2, m0,
                    valid);
  }
}

// The weights' copy in the operand type (bf16 or f16) for bf16 or f16 activations.
template <typename S>
__global__ void __launch_bounds__(kThreads) to_operand_kernel(const float* __restrict__ a, S* __restrict__ out,
                                                              int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = ftt::from_float<S>(a[i]);
}

// y = x + (sum of the shares' partial sums, in share order, + b2), four channels a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_shares_kernel(const float* __restrict__ partial, const T* __restrict__ x, const float* __restrict__ b2,
                  T* __restrict__ y, int64_t n4, int C, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const int64_t n = 4 * n4;
  float4 s = reinterpret_cast<const float4*>(partial)[i];
  for (int k = 1; k < splits; ++k) {
    const float4 p = reinterpret_cast<const float4*>(partial + k * n)[i];
    s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
  }
  const int c = static_cast<int>((4 * i) % C);
  const float4 b = *reinterpret_cast<const float4*>(b2 + c);
  Mma<T>::store2(y + 4 * i, ftt::to_float(x[4 * i]) + (s.x + b.x), ftt::to_float(x[4 * i + 1]) + (s.y + b.y));
  Mma<T>::store2(y + 4 * i + 2, ftt::to_float(x[4 * i + 2]) + (s.z + b.z), ftt::to_float(x[4 * i + 3]) + (s.w + b.w));
}

// Shares of the hidden width for M tokens on the current device.  One where
// the weights stay resident; else the shares double, while each keeps whole
// chunks, as long as the blocks still fit the card's multiprocessors in one
// wave (on the H100, shares past one wave cost more than the card they fill).
template <class Cf>
cudaError_t plan_shares(int64_t M, int H, int* shares) {
  *shares = 1;
  if (Cf::kResident) return H == Cf::H ? cudaSuccess : cudaErrorInvalidValue;
  if (H % Cf::HC) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (M + Cf::TM - 1) / Cf::TM;
  while (2 * tiles * *shares <= sms && H % (2 * *shares * Cf::HC) == 0) *shares *= 2;
  return cudaSuccess;
}

template <typename T, class Cf>
cudaError_t launch(const void* x_, void* y_, const float* const* p, float* partial, const typename Mma<T>::S* w1,
                   const typename Mma<T>::S* w2, int64_t M, int H, float eps, cudaStream_t stream) {
  using Sm = typename Cf::template Smem<T>;
  int splits = 1;
  cudaError_t err = plan_shares<Cf>(M, H, &splits);
  if (err != cudaSuccess) return err;
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  auto kernel = prenorm_mlp_fwd_kernel<T, Cf>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Sm::BYTES));
  if (err != cudaSuccess) return err;
  const int64_t tiles = (M + Cf::TM - 1) / Cf::TM;
  int64_t blocks = tiles * splits;
  if (Cf::kResident) {  // persistent: as many blocks as the card holds at once
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Cf::kThreads, Sm::BYTES);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = tiles < static_cast<int64_t>(sms) * per_sm ? tiles : static_cast<int64_t>(sms) * per_sm;
  }
  const T* x = static_cast<const T*>(x_);
  T* y = static_cast<T*>(y_);
  kernel<<<static_cast<unsigned>(blocks), Cf::kThreads, Sm::BYTES, stream>>>(x, y, partial, p[0], p[1], w1, p[3], w2,
                                                                         p[5], M, H, eps, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t n4 = M * Cf::C / 4;
  sum_shares_kernel<T><<<static_cast<unsigned>((n4 + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      partial, x, p[5], y, n4, Cf::C, splits);
  return cudaGetLastError();
}

// f(Cf{}) with the configuration for width C and hidden width H:
// Cfg<C, tokens a tile, hidden chunk, weights resident[, warps]>.  C = 64
// takes 16 warps (~5 % faster than 8 on the H100), the others 8.
template <typename F>
cudaError_t with_cfg(int C, int H, F&& f) {
  const bool resident = H == 4 * C;
  switch (C) {
    case 32: return resident ? f(Cfg<32, 64, 64, true>{}) : f(Cfg<32, 64, 32, false>{});
    case 64: return resident ? f(Cfg<64, 64, 64, true, 16>{}) : f(Cfg<64, 64, 32, false>{});
    case 128: return f(Cfg<128, 64, 32, false>{});
    case 256: return f(Cfg<256, 64, 32, false>{});
    case 512: return f(Cfg<512, 32, 32, false>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, void* y, const float* const* p, float* partial, const typename Mma<T>::S* w1,
                     const typename Mma<T>::S* w2, int64_t M, int C, int H, float eps, cudaStream_t s) {
  return with_cfg(C, H, [&](auto cfg) { return launch<T, decltype(cfg)>(x, y, p, partial, w1, w2, M, H, eps, s); });
}

// 16-bit activations: the weights copied to `wconv` in the operand type (W1, then W2), then the kernel.
template <typename T>
cudaError_t dispatch16(const void* x, void* y, const float* const* p, float* partial, void* wconv, int64_t M, int C,
                       int H, float eps, cudaStream_t s) {
  if (wconv == nullptr) return cudaErrorInvalidValue;
  auto w1h = static_cast<T*>(wconv);
  auto w2h = w1h + static_cast<int64_t>(H) * C;
  const int64_t n = static_cast<int64_t>(H) * C;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  to_operand_kernel<T><<<grid, kThreads, 0, s>>>(p[2], w1h, n);
  to_operand_kernel<T><<<grid, kThreads, 0, s>>>(p[4], w2h, n);
  return dispatch<T>(x, y, p, partial, w1h, w2h, M, C, H, eps, s);
}

}  // namespace

// The shares of the hidden width that ftt_prenorm_mlp splits M tokens into
// on the current device (plan_shares), into *shares.  Returns a CUDA status.
extern "C" int ftt_prenorm_mlp_shares(long long M, int C, int H, int* shares) {
  if (M <= 0 || H <= 0 || H % 32) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_cfg(C, H, [&](auto cfg) { return plan_shares<decltype(cfg)>(M, H, shares); }));
}

// x, y: (M, C) contiguous, of `dtype`, 16-byte aligned; gamma, beta, b2:
// (C,); w1: (H, C); b1: (H,); w2: (C, H); all parameters f32 and 16-byte
// aligned; H a multiple of 32.  partial: (shares, M, C) f32 scratch when
// ftt_prenorm_mlp_shares gives more than one share, else unused; wconv:
// 2 H C 16-bit values of scratch for the weights' copy in the operand type
// when dtype is bf16 or f16, else unused.  Returns cudaGetLastError().
extern "C" int ftt_prenorm_mlp(const void* x, void* y, const void* gamma, const void* beta, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* partial, void* wconv, int dtype,
                               long long M, int C, int H, float eps, void* stream) {
  const float* params[6] = {static_cast<const float*>(gamma), static_cast<const float*>(beta),
                            static_cast<const float*>(w1),    static_cast<const float*>(b1),
                            static_cast<const float*>(w2),    static_cast<const float*>(b2)};
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partial);
  cudaError_t err;
  if (M <= 0 || H <= 0 || H % 32) {
    err = cudaErrorInvalidValue;
  } else if (dtype == ftt::kFloat32) {
    err = dispatch<float>(x, y, params, part, params[2], params[4], M, C, H, eps, s);
  } else if (dtype == ftt::kBFloat16) {
    err = dispatch16<__nv_bfloat16>(x, y, params, part, wconv, M, C, H, eps, s);
  } else if (dtype == ftt::kFloat16) {
    err = dispatch16<__half>(x, y, params, part, wconv, M, C, H, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
