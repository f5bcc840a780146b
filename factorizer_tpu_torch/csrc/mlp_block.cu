// K2, forward: fused pre-norm MLP residual, y = x + fc2(gelu(fc1(LN(x)))).
//
// Replaces the Pallas kernels `_fwd_kernel` (factorizer_tpu/ops/pallas/
// mlp_block.py:183, launched by `_fwd_fn` at :293) and `_slab_fwd_kernel`
// (:493, launched by `_slab_fwd_fn` at :596) under `fused_prenorm_mlp` (:735).
// The two TPU kernels compute the same function in two TPU layouts; this one
// kernel serves every block tail of the model: C in {32, 64, 128, 256, 512},
// any hidden width H that is a multiple of the chunk, f32 or bf16
// activations, f32 parameters and f32 arithmetic throughout.  GELU is the
// exact erf form (`erff`), as the unfused module computes it.
//
// What bounds it on the H100: arithmetic.  Per token it does 4*C*H = 16*C^2
// flops against 2*C activation elements of device-memory traffic (the hidden
// activations never leave the block), e.g. 512 flops per byte at C = 32 in
// f32.  On the CUDA cores (67 TFLOP/s f32 at 700 W) that is ~1 ms of compute
// for the (2,128^3,32) stage versus ~0.2 ms of memory traffic.
//
// What the design does about it: a block takes TM tokens, normalises them
// into shared memory (two-pass f32 statistics, one warp per token), then
// walks the hidden width in chunks of HC: the chunk of W1 (torch layout
// (H, C)) and of W2 ((C, H)) is staged in shared memory from L2, h = xn W1^T
// + b1 is a register-tiled product, GELU goes to shared memory, and the
// chunk's contribution to y is accumulated in registers.  The residual and
// b2 are added in the epilogue.  Tile shapes are chosen per C so that each
// thread keeps at most 64 accumulators and a block at most ~120 KB of shared
// memory.  The products run as CUDA-core FMAs; tensor cores (wgmma) and TMA
// staging are left for a later change.
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
  static constexpr int RN2 = C / TX;    // output channels per thread
  static constexpr int LDX = TM + 1;    // odd strides: conflict-free shared-memory access
  static constexpr int LDW1 = HC + 1;
  static constexpr int LDW2 = C + 1;
  static constexpr int LDG = TM + 1;
  static constexpr size_t kSmemFloats =
      static_cast<size_t>(C) * LDX + C * LDW1 + HC * LDW2 + HC * LDG + HC;
  static_assert(TM % TY == 0 && HC % TX == 0 && C % TX == 0 && C % 32 == 0, "bad tile");
};

template <typename T, int C, int TM, int HC, int TY>
__global__ void __launch_bounds__(kThreads)
prenorm_mlp_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, int64_t M, int H, float eps) {
  using Tl = Tile<C, TM, HC, TY>;
  constexpr int TX = Tl::TX, RM = Tl::RM, RN1 = Tl::RN1, RN2 = Tl::RN2;
  extern __shared__ float smem[];
  float* xn = smem;                    // [C][LDX]   normalised tokens, k-major
  float* w1s = xn + C * Tl::LDX;       // [C][LDW1]  W1 chunk, k-major
  float* w2s = w1s + C * Tl::LDW1;     // [HC][LDW2] W2 chunk, hidden-major
  float* gs = w2s + HC * Tl::LDW2;     // [HC][LDG]  gelu(h) chunk
  float* b1s = gs + HC * Tl::LDG;      // [HC]

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * TM;

  // LayerNorm over C, one warp per token: mean, then mean of centred squares.
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
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      xn[c * Tl::LDX + m] = (vals[i] - mean) * rstd * gamma[c] + beta[c];
    }
  }

  float acc2[RM][RN2];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int r = 0; r < RN2; ++r) acc2[i][r] = 0.f;

  for (int j0 = 0; j0 < H; j0 += HC) {
    __syncthreads();  // the previous chunk is consumed; the normalised tokens are visible
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

    float acc1[RM][RN1];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int r = 0; r < RN1; ++r) acc1[i][r] = b1s[tx + TX * r];
    for (int k = 0; k < C; ++k) {
      float a[RM], bw[RN1];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = xn[k * Tl::LDX + ty + TY * i];
#pragma unroll
      for (int r = 0; r < RN1; ++r) bw[r] = w1s[k * Tl::LDW1 + tx + TX * r];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int r = 0; r < RN1; ++r) acc1[i][r] = fmaf(a[i], bw[r], acc1[i][r]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int r = 0; r < RN1; ++r) {
        const float h = acc1[i][r];
        gs[(tx + TX * r) * Tl::LDG + ty + TY * i] = 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
      }
    __syncthreads();

    for (int j = 0; j < HC; ++j) {
      float a[RM], bw[RN2];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = gs[j * Tl::LDG + ty + TY * i];
#pragma unroll
      for (int r = 0; r < RN2; ++r) bw[r] = w2s[j * Tl::LDW2 + tx + TX * r];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int r = 0; r < RN2; ++r) acc2[i][r] = fmaf(a[i], bw[r], acc2[i][r]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t row = m0 + ty + TY * i;
    if (row >= M) continue;
#pragma unroll
    for (int r = 0; r < RN2; ++r) {
      const int n = tx + TX * r;
      y[row * C + n] = ftt::from_float<T>(ftt::to_float(x[row * C + n]) + acc2[i][r] + b2[n]);
    }
  }
}

template <typename T, int C, int TM, int HC, int TY>
cudaError_t launch(const void* x, void* y, const float* const* p, int64_t M, int H, float eps,
                   cudaStream_t stream) {
  if (H % HC) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * Tile<C, TM, HC, TY>::kSmemFloats;
  auto kernel = prenorm_mlp_kernel<T, C, TM, HC, TY>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (M + TM - 1) / TM;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), p[0], p[1], p[2], p[3], p[4], p[5], M, H, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* y, const float* const* p, int64_t M, int C, int H,
                     float eps, cudaStream_t s) {
  switch (C) {  // <T, C, tokens per block, hidden chunk, thread rows>
    case 32: return launch<T, 32, 128, 32, 32>(x, y, p, M, H, eps, s);
    case 64: return launch<T, 64, 64, 64, 16>(x, y, p, M, H, eps, s);
    case 128: return launch<T, 128, 64, 64, 16>(x, y, p, M, H, eps, s);
    case 256: return launch<T, 256, 32, 32, 16>(x, y, p, M, H, eps, s);
    case 512: return launch<T, 512, 16, 16, 16>(x, y, p, M, H, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (M, C) contiguous, of `dtype`; gamma, beta, b2: (C,); w1: (H, C);
// b1: (H,); w2: (C, H); all parameters f32.  Returns cudaGetLastError().
extern "C" int ftt_prenorm_mlp(const void* x, void* y, const void* gamma, const void* beta,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               int dtype, long long M, int C, int H, float eps, void* stream) {
  const float* params[6] = {static_cast<const float*>(gamma), static_cast<const float*>(beta),
                            static_cast<const float*>(w1),    static_cast<const float*>(b1),
                            static_cast<const float*>(w2),    static_cast<const float*>(b2)};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M <= 0 || H <= 0) {
    err = cudaErrorInvalidValue;
  } else if (dtype == ftt::kFloat32) {
    err = dispatch<float>(x, y, params, M, C, H, eps, s);
  } else if (dtype == ftt::kBFloat16) {
    err = dispatch<__nv_bfloat16>(x, y, params, M, C, H, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
