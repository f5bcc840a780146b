// Shared by the depthwise-convolution kernels (K3): the run length and the
// decomposition of a spatial unit.
#pragma once

#include "common.cuh"

namespace ftt {

// Consecutive positions along the innermost spatial axis that one thread owns.
// A thread reads kRun + k3 - 1 inputs per tap row and reuses each in up to k3
// products, so a 3-tap row costs 1.25 loads per output instead of 3.
constexpr int kRun = 8;
// Channels per warp: neighbouring threads take neighbouring channels, the
// contiguous axis, so a warp's load is one 128-byte line in f32.
constexpr int kLanes = 32;

// A unit is one run of one row, numbered (i1, run, i2) with i2 innermost: the
// warps of a block then sit on neighbouring rows of one run, and the tap rows
// they read overlap, so most of a block's loads hit L1.
struct Unit {
  int i1, i2, s0;
};

__device__ __forceinline__ Unit unit_of(int u, int S2, int runs) {
  Unit t;
  t.i2 = u % S2;
  u /= S2;
  t.s0 = (u % runs) * kRun;
  t.i1 = u / runs;
  return t;
}

}  // namespace ftt
