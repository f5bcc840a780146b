"""K4's launch plan (``ops/kernels/nmf.py::nmf_plan``), pinned at the sizes the port runs, without a card.

The plan mirrors ``csrc/nmf_plan.cuh``: the register kernels at the bundles' sizes ``(8, 512)`` and ``(8, 64)``
(forward at ranks 1 to 4, backward at rank 1), the shared-memory kernels at any other size that fits.
``chip_smoke.py`` holds the mirror against the library's ``ftt_nmf_plan_query``; these tests pin the table
itself, and ``supports`` / ``supports_backward`` as its verdicts.
"""

import pytest
import torch

from factorizer_tpu_torch.ops.kernels.nmf import NmfPlan, nmf_plan, supports, supports_backward

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16

# (M, N): threads a group, matrices a 128-thread block; the register forward's blocks an SM by rank (its
# __launch_bounds__ blocks, at the registers ptxas takes for each instance) and the backward's.
GROUP = {(8, 512): (128, 1), (8, 64): (32, 4)}
FWD_RESIDENT = {(8, 512): (5, 4, 3, 2), (8, 64): (9, 6, 5, 4)}
BWD_RESIDENT = {(8, 512): 4, (8, 64): 5}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rank", [1, 2, 3, 4])
@pytest.mark.parametrize("size", [(8, 512), (8, 64)])
def test_register_forward_at_the_bundles_sizes(size, rank, dtype):
    """Every rank takes the register route forward: one group of 4 warps a matrix at N = 512, four one-warp groups
    a block at N = 64; shared memory holds only the group sums (two phases of each warp's 8 R + R (R + 1) / 2
    sums, 9 at rank 1, in 16-byte rows above it); the grid covers the batch."""
    n_mats = 131072
    plan = nmf_plan("hals", rank, size, dtype, 5, n_mats)
    group_threads, per_block = GROUP[size]
    warps = group_threads // 32
    sums = 9 if rank == 1 else -(-(8 * rank + rank * (rank + 1) // 2) // 4) * 4
    resident = FWD_RESIDENT[size][rank - 1]
    assert plan == NmfPlan("registers", group_threads, per_block, 128, 4 * 2 * warps * sums * per_block, resident,
                           n_mats // per_block, resident, n_mats // per_block / (132 * resident))
    assert nmf_plan("mu", rank, size, dtype, 5, n_mats) == plan  # the solver does not change the launch


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("size", [(8, 512), (8, 64)])
def test_register_backward_at_rank_1(size, dtype):
    """The rank-1 backward takes the register route: its shared memory holds the iterates (v_t and u_t for t = 0..T,
    a_u and b_u per iteration) and the group sums; ranks 2 to 4 have no backward kernel (a torch recompute)."""
    n_mats, t = 524288, 5
    plan = nmf_plan("hals", 1, size, dtype, t, n_mats, backward=True)
    group_threads, per_block = GROUP[size]
    m, n = size
    floats = (t + 1) * (n + m) + t * (m + 1) + 18 * (group_threads // 32)
    assert plan == NmfPlan("registers", group_threads, per_block, 128, 4 * floats * per_block, BWD_RESIDENT[size],
                           n_mats // per_block, BWD_RESIDENT[size], n_mats // per_block / (132 * BWD_RESIDENT[size]))
    assert plan.smem == {(8, 512): 12948, (8, 64): 7920}[size]
    for rank in (2, 3, 4):
        assert nmf_plan("hals", rank, size, dtype, t, n_mats, backward=True) is None
        assert supports_backward("hals", rank, size)


def test_shared_route_at_the_general_sizes():
    """(5, 37) and (8, 4096) take the shared-memory kernels: a block a matrix, as many threads as N needs
    (at most 256), the matrix transposed to [N][M | 1] with its factors; the backward keeps more on chip, so
    (8, 4096) has a forward plan and no backward one.  Their launch bounds name threads alone, so resident blocks
    count from 255 registers a thread: low, where ptxas takes fewer."""
    odd = nmf_plan("hals", 3, (5, 37), F32, 5, 1000)
    assert odd == NmfPlan("shared", 64, 1, 64, 4 * (37 * 5 + 42 * 3 + 12 * 5 * 3 + 81), 4, 1000, 1, 1000 / (132 * 4))
    odd_bwd = nmf_plan("hals", 1, (5, 37), F32, 5, 1000, backward=True)
    assert odd_bwd == NmfPlan("shared", 64, 1, 64, 4 * (2 * 37 * 6 + 6 * 42 + 5 * 6 + 74 + 15 + 64 + 33), 4, 1000, 1,
                              1000 / (132 * 4))
    big = nmf_plan("hals", 1, (8, 4096), F32, 5, 2048)
    assert (big.route, big.threads, big.smem, big.resident, big.blocks) == ("shared", 256, 164932, 1, 2048)
    assert nmf_plan("hals", 1, (8, 4096), F32, 5, 2048, backward=True) is None


def test_shared_route_asked_for_by_name():
    """``route="shared"`` gives the shared-memory plan at a register size, forward and backward (to compare the two
    kernels on one size); it does not exist where the register route does not apply, nor does any other route."""
    shared = nmf_plan("hals", 1, (8, 512), F32, 5, 131072, route="shared")
    assert (shared.route, shared.threads, shared.blocks, shared.resident) == ("shared", 256, 131072, 1)
    assert shared.smem == 4 * (512 * 9 + 520 + 32 * 8 + 9)
    bwd = nmf_plan("hals", 1, (8, 64), BF16, 5, 32768, backward=True, route="shared")
    assert (bwd.route, bwd.threads, bwd.blocks) == ("shared", 64, 32768)
    assert nmf_plan("hals", 1, (5, 37), F32, 5, 1, route="shared") is None
    assert nmf_plan("hals", 1, (8, 512), F32, 5, 1, route="staged") is None


def test_backward_route_moves_with_the_iterates():
    """The register backward keeps every iterate in shared memory: (8, 512) fits 108 iterations and no more, and
    then nothing fits; (8, 64) fits 178 in registers, and up to 699 on the shared-memory route."""
    assert nmf_plan("hals", 1, (8, 512), F32, 108, 1, backward=True).route == "registers"
    assert nmf_plan("hals", 1, (8, 512), F32, 109, 1, backward=True) is None
    assert supports_backward("hals", 1, (8, 512), 108) and not supports_backward("hals", 1, (8, 512), 109)
    assert nmf_plan("hals", 1, (8, 64), F32, 178, 1, backward=True).route == "registers"
    assert nmf_plan("hals", 1, (8, 64), F32, 179, 1, backward=True).route == "shared"
    assert nmf_plan("hals", 1, (8, 64), F32, 699, 1, backward=True).route == "shared"
    assert nmf_plan("hals", 1, (8, 64), F32, 700, 1, backward=True) is None


def test_supports_edges():
    """``supports`` / ``supports_backward`` are the plan's verdicts: solver, rank, size, iterations, and the rows
    the shared-memory backward gives a thread each."""
    assert supports("hals", 4, (8, 512)) and supports("mu", 4, (8, 64)) and not supports("hals", 5, (8, 512))
    assert not supports("cd", 1, (8, 512)) and not supports("hals", 1, (8, 512), num_iters=0)
    assert supports("hals", 1, (256, 27)) and supports_backward("hals", 1, (256, 27))
    assert supports("hals", 1, (257, 27)) and not supports_backward("hals", 1, (257, 27))
    assert not supports("hals", 2, (64, 1024)) and not supports_backward("hals", 2, (64, 1024))
    assert nmf_plan("hals", 1, (8, 512), torch.float16) == nmf_plan("hals", 1, (8, 512), torch.bfloat16)
    assert nmf_plan("hals", 1, (8, 512), torch.float64) is None and nmf_plan("hals", 1, (8, 512), n_mats=0) is None


def test_describe_and_query():
    """The plan's one-line description and its fields in ``ftt_nmf_plan_query``'s order (route index first)."""
    plan = nmf_plan("hals", 1, (8, 64), F32, 5, 524288)
    assert plan.query() == (0, 32, 4, 128, 288, 9, 131072, 9)
    assert plan.describe() == "registers route, 32 threads a matrix, 4 a block of 128, 131072 blocks, 110.33 waves, 0.3 KB"
    assert nmf_plan("hals", 1, (5, 37), F32, 5, 1000).query()[0] == 1
