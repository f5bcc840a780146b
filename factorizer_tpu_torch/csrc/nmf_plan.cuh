// K4's launch plan: which kernel takes a call of the flat NMF, forward or
// rank-1 backward, and how it is launched.  The entry points (nmf.cu,
// nmf_bwd.cu) follow it; ops/kernels/nmf.py::nmf_plan mirrors it in Python,
// and chip_smoke.py holds the two against each other (ftt_nmf_plan_query).
//
// Two routes:
//   * registers, at the bundles' sizes M = 8 and N = 512 or 64 (head_dim 8,
//     patches of 8^3, or 4^3 and 8^2): a thread group holds a matrix in
//     registers (Group<8, kP>: 4 warps at N = 512, one warp at N = 64, four
//     matrices to a 128-thread block), forward at ranks 1 to 4, backward at
//     rank 1;
//   * shared, any other size that fits: a block a matrix, the matrix and its
//     factors in shared memory.
// The shared route can be asked for at a register size, to compare the
// kernels on one size.
// Resident blocks are counted from the registers a thread that the kernel's
// __launch_bounds__ allow (where ptxas takes fewer, more blocks fit and the
// count is low), the threads, the blocks and the shared memory an SM holds.
#pragma once

#include "rank1_nmf_bwd.cuh"

namespace ftt {

enum NmfRoute : int { kNmfNone = -1, kNmfRegisters = 0, kNmfShared = 1 };

constexpr int kNmfMaxRank = 4;
constexpr int kNmfSmemLimit = 227 * 1024;  // shared memory a block may use
constexpr int kNmfMaxThreads = 256;        // the shared-memory forward's largest block
constexpr int kNmfBwdMaxRows = 256;        // the shared-memory backward gives each row of x a thread
constexpr int kNmfGroupBlock = 128;        // Group<8, kP>::kBlock
// What one SM of an H100 holds: shared memory, threads, blocks, registers.
constexpr int kSmSmem = 233472, kSmThreads = 2048, kSmBlocks = 32, kSmRegs = 65536;

// The second argument of each K4 kernel's __launch_bounds__: for the
// register kernels at N = 512 and 64, the forward by rank and the rank-1
// backward, the blocks an SM holds at the registers ptxas takes for each
// kernel without a bound (sm_90a, nvcc 12.9; chip_smoke.py's [build] lines
// print the counts), so that the bound changes no code and the plan counts
// what runs.  The shared-memory kernels keep their bound on threads alone
// (1): a cap of 128 registers let ptxas take 72 where it takes 40 and cost
// them a third of their speed, so their resident blocks count low.
__host__ __device__ constexpr int nmf_group_min_blocks(int rank, bool backward, int N) {
  return backward ? (N == 512 ? 4 : 5)
                  : (N == 512 ? (rank == 1 ? 5 : rank == 2 ? 4 : rank == 3 ? 3 : 2)
                              : (rank == 1 ? 9 : rank == 2 ? 6 : rank == 3 ? 5 : 4));
}
constexpr int kNmfSharedMinBlocks = 1;

// The sums one group_sum call of the rank-R forward reduces: X v (8 R) and
// the upper triangle of v^T v; rank 1 uses group_sum9.
__host__ __device__ constexpr int nmf_group_sums(int rank) { return rank == 1 ? 9 : 8 * rank + rank * (rank + 1) / 2; }
__host__ __device__ constexpr int nmf_group_sum_stride(int rank) {
  return rank == 1 ? 9 : group_sum_stride(nmf_group_sums(rank));
}

// Floats of shared memory of one block of the shared-memory forward: the
// transposed matrix [N][M | 1], v, u, the partial sums over chunks of rows
// and block_sum_vec's buffer.
inline size_t nmf_shared_fwd_floats(int rank, int M, int N, int threads) {
  const int chunks = threads / M > 0 ? threads / M : 1;
  return static_cast<size_t>(N) * (M | 1) + static_cast<size_t>(N + M) * rank +
         static_cast<size_t>(chunks) * M * rank + 9 * rank * rank;
}

// Threads of a shared-memory forward block: one a column, in whole warps, at most 256.
inline int nmf_shared_fwd_threads(int N) {
  const int t = (N + 31) / 32 * 32;
  return t > kNmfMaxThreads ? kNmfMaxThreads : t;
}

// Threads of a shared-memory backward block: 64 for matrices up to 64 x 64, else 256.
inline int nmf_shared_bwd_threads(int M, int N) { return M <= 64 && N <= 64 ? 64 : 256; }

inline bool nmf_register_size(int M, int N) { return M == 8 && (N == 512 || N == 64); }

struct NmfPlan {
  int route;          // NmfRoute
  int group_threads;  // threads that hold one matrix
  int per_block;      // matrices a block
  int threads;        // threads a block
  int smem;           // bytes of shared memory a block, static and dynamic
  int resident;       // blocks one SM holds
  long long blocks;   // the grid
};

// Lets `Kernel` take up to kNmfSmemLimit bytes of dynamic shared memory,
// once per device and not at every launch (which also keeps the attribute
// call out of a CUDA graph's capture), where a launch needs more than 48 KB.
template <auto Kernel>
inline cudaError_t allow_nmf_smem(int smem) {
  static unsigned done = 0;  // a bit per device
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kNmfSmemLimit);
  if (err == cudaSuccess) done |= bit;
  return err;
}

// Blocks of `threads` threads and `smem` bytes that one SM holds, at the
// registers that __launch_bounds__(bound_threads, min_blocks) allows.
inline int nmf_resident(int threads, int smem, int bound_threads, int min_blocks) {
  int regs = kSmRegs / (bound_threads * min_blocks);
  regs = regs > 255 ? 255 : regs;
  int r = kSmBlocks;
  const int by_threads = kSmThreads / threads, by_regs = kSmRegs / (regs * threads), by_smem = kSmSmem / (smem + 1024);
  r = by_threads < r ? by_threads : r;
  r = by_regs < r ? by_regs : r;
  return by_smem < r ? by_smem : r;
}

// The plan of a call on n_mats (M, N) matrices of `elt`-byte elements at
// `rank`, `num_iters` iterations; `backward`: the rank-1 backward.  `want`:
// kNmfNone lets the plan choose; kNmfShared asks for the shared-memory route
// at a size the register route takes (to compare the routes on one size).  A
// plan with route kNmfNone: no kernel takes the call.
inline NmfPlan nmf_plan(int rank, int M, int N, int elt, int num_iters, long long n_mats, bool backward,
                        int want = kNmfNone) {
  NmfPlan p{kNmfNone, 0, 0, 0, 0, 0, 0};
  if (rank < 1 || rank > (backward ? 1 : kNmfMaxRank) || M < 1 || N < 1 || num_iters < 1 || n_mats < 1 ||
      (elt != 4 && elt != 2) || (want != kNmfNone && want != kNmfShared) ||
      (want == kNmfShared && !nmf_register_size(M, N))) {
    return p;
  }
  if (want == kNmfNone && nmf_register_size(M, N)) {
    p.group_threads = N == 512 ? 128 : 32;
    p.per_block = kNmfGroupBlock / p.group_threads;
    p.threads = kNmfGroupBlock;
    const int warps = p.group_threads / 32;
    const size_t floats = backward ? rank1_group_bwd_smem_floats(N, M, num_iters, warps)
                                   : 2 * static_cast<size_t>(warps) * nmf_group_sum_stride(rank);
    if (4 * floats * p.per_block <= static_cast<size_t>(kNmfSmemLimit)) {
      p.route = kNmfRegisters;
      p.smem = static_cast<int>(4 * floats * p.per_block);
      p.resident = nmf_resident(p.threads, p.smem, kNmfGroupBlock, nmf_group_min_blocks(rank, backward, N));
      p.blocks = (n_mats + p.per_block - 1) / p.per_block;
      return p;
    }
  }
  size_t floats;
  int bound;
  if (backward) {
    if (M > kNmfBwdMaxRows) return p;
    p.threads = bound = nmf_shared_bwd_threads(M, N);
    floats = rank1_bwd_smem_floats(N, M, num_iters, p.threads);
  } else {
    p.threads = nmf_shared_fwd_threads(N);
    bound = kNmfMaxThreads;
    floats = nmf_shared_fwd_floats(rank, M, N, p.threads);
  }
  if (4 * floats > static_cast<size_t>(kNmfSmemLimit)) return p;
  p.route = kNmfShared;
  p.group_threads = p.threads;
  p.per_block = 1;
  p.smem = static_cast<int>(4 * floats);
  p.resident = nmf_resident(p.threads, p.smem, bound, kNmfSharedMinBlocks);
  p.blocks = n_mats;
  return p;
}

}  // namespace ftt
