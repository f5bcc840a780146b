// The tensor-core fragments of K2's forward (mlp_block.cu) and backward
// (mlp_block_bwd.cu): mma.sync m16n8k8 TF32 in three passes for f32 operands,
// m16n8k16 bf16 for bf16 operands, f32 accumulation.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ftt {

template <typename T> struct Mma;

// f32 activations: three-pass TF32, f32 accumulation.
template <> struct Mma<float> {
  using S = float;                 // shared-memory operand type
  static constexpr int kK = 8;     // depth of one mma
  static constexpr int kPad = 4;   // row padding, elements
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  // hi: v cut to TF32's 10 mantissa bits; lo: the exact rest, cut the same way (~2^-21 of v is lost).
  static __device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(v) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
  }
  // Rows [r0, r0 + 16) x depth [k0, k0 + 8) of a row-major tile.
  static __device__ __forceinline__ A load_a(const S* a, int ld, int r0, int k0, int lane) {
    const S* p = a + (r0 + (lane >> 2)) * ld + k0 + (lane & 3);
    A f;
    split(p[0], f.hi[0], f.lo[0]);
    split(p[8 * ld], f.hi[1], f.lo[1]);
    split(p[4], f.hi[2], f.lo[2]);
    split(p[8 * ld + 4], f.hi[3], f.lo[3]);
    return f;
  }
  // Columns [n0, n0 + 8) x depth [k0, k0 + 8) of a tile stored column by column (a row of `b` is a column).
  static __device__ __forceinline__ B load_b(const S* b, int ld, int n0, int k0, int lane) {
    const S* p = b + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
    B f;
    split(p[0], f.hi[0], f.lo[0]);
    split(p[4], f.hi[1], f.lo[1]);
    return f;
  }
  static __device__ __forceinline__ void mma1(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    mma1(c, a.lo, b.hi);
    mma1(c, a.hi, b.lo);
    mma1(c, a.hi, b.hi);
  }
  // The three passes into separate sums (lo*hi, hi*lo, hi*hi), three chains where `mma` makes one.
  static constexpr int kPasses = 3;
  static __device__ __forceinline__ void mma_passes(float (&c)[kPasses][4], const A& a, const B& b) {
    mma1(c[0], a.lo, b.hi);
    mma1(c[1], a.hi, b.lo);
    mma1(c[2], a.hi, b.hi);
  }
  static __device__ __forceinline__ void store2(S* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
};

// bf16 activations: bf16 operands, f32 accumulation.
template <> struct Mma<__nv_bfloat16> {
  using S = __nv_bfloat16;
  static constexpr int kK = 16;
  static constexpr int kPad = 8;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  static __device__ __forceinline__ uint32_t pair(const S* p) { return *reinterpret_cast<const uint32_t*>(p); }
  static __device__ __forceinline__ A load_a(const S* a, int ld, int r0, int k0, int lane) {
    const S* p = a + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    return A{{pair(p), pair(p + 8 * ld), pair(p + 8), pair(p + 8 * ld + 8)}};
  }
  static __device__ __forceinline__ B load_b(const S* b, int ld, int n0, int k0, int lane) {
    const S* p = b + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    return B{{pair(p), pair(p + 8)}};
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
  static constexpr int kPasses = 1;
  static __device__ __forceinline__ void mma_passes(float (&c)[kPasses][4], const A& a, const B& b) { mma(c[0], a, b); }
  static __device__ __forceinline__ void store2(S* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

}  // namespace ftt
