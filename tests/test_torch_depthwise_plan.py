"""K3's launch plan, and a plain-torch model of the tiled walk that the plan and the layout describe, on the CPU.

The tiled kernels of ``csrc/depthwise_conv.cu`` and ``csrc/depthwise_conv_dw.cu``
run only on the card, but their plan is chosen in Python
(``ops/kernels/depthwise_conv.py::conv_plan``).  Here the plan is checked at the
shapes the bundles run (grid within CUDA's limits, shared memory within 227 KB,
two waves of blocks on 132 SMs where the shape has the work for them), and a
plain-torch model of the walk that the plan describes (the ring of input planes
in ``tile_layout``'s places, the block's taps, the partial sets summed in block
order) is held against the plain versions in float64.  The model checks the
plan and the Python copy of the layout: that the tiles cover every output once
and read only inside their halo boxes.  It does not run the kernels' own index
arithmetic, which ``chip_smoke.py`` holds against the plain versions on the card
(odd tile remainders included).  Inputs come from a numpy seed.
"""

import math

import numpy as np
import pytest
import torch

from factorizer_tpu_torch.ops.kernels import depthwise_conv_dw_plain, depthwise_conv_plain
from factorizer_tpu_torch.ops.kernels.depthwise_conv import TILE, ConvPlan, conv_plan, tile_layout, tile_min_blocks, tile_rows

torch.set_num_threads(1)

SMS = 132
SMEM_LIMIT = 232448  # 227 KB: the most shared memory one block of an H100 can take
F32, BF16 = torch.float32, torch.bfloat16
STAGES = [(128, 32), (64, 64), (32, 128), (16, 256), (8, 512)]
# (x shape, kernel size, dtype) of the bundles and of chip_smoke.py's K3 cases.
BUNDLE_SHAPES = [((2, s, s, s, c), (3, 3, 3), dt) for s, c in STAGES for dt in (F32, BF16)] + [
    ((16, 512, 512, 32), (7, 7), F32),  # FIVES stage 0
    ((16, 128, 128, 128), (7, 7), F32),  # FIVES stage 2
    ((8, 64, 64, 64, 32), (3, 3, 3), F32),  # deconver_isles22's train batch
    ((2, 64, 64, 64, 48), (3, 3, 3), F32),
    ((2, 64, 64, 64, 64), (3, 3, 3), F32),
    ((2, 32, 32, 32, 128), (1, 3, 5), F32),
    # The spatial step's slabs and their halos (train_tp.yaml on 2 slabs): deconver_brats23's stages 0 and 1,
    # 64 + 2 and 32 + 2 rows, and deconver_fives' stage 0, 256 + 6 rows of H.
    ((2, 66, 128, 128, 32), (3, 3, 3), F32),
    ((2, 34, 64, 64, 64), (3, 3, 3), F32),
    ((16, 262, 512, 32), (7, 7), F32),
]
# Shapes whose plan, cut as far as it goes, still gives fewer than two waves: the deepest stages hold too few
# outputs (2 x 8^3 x 512 is 64 blocks of 64 threads per plane pair, at 32 channels a block).
FEW_WAVES = {((2, 8, 8, 8, 512), dt, dw) for dt in (F32, BF16) for dw in (False, True)} | {((2, 16, 16, 16, 256), BF16, False)}


def _label(case):
    shape, ks, dt = case
    return f"{'x'.join(map(str, shape))}-k{''.join(map(str, ks))}-{str(dt)[6:]}"


@pytest.mark.parametrize("dw", [False, True], ids=["fwd", "dw"])
@pytest.mark.parametrize("case", BUNDLE_SHAPES, ids=_label)
def test_plan_fits_the_card(case, dw):
    """The bundles' shapes take the tiled kernels with a grid CUDA accepts, shared memory within 227 KB, at most
    256 threads a block, and two waves of blocks on 132 SMs unless even the smallest cut lacks the work."""
    shape, ks, dt = case
    plan = conv_plan(shape, ks, dt, SMS, dw=dw)
    assert plan.route == "tile"
    b, s1, s2, s3, c = plan.shape
    assert b == shape[0] and c == shape[-1] and s1 * s2 * s3 == math.prod(shape[1:-1])
    assert plan.grid[0] < 2**31 and plan.grid[1] <= 65535 and plan.grid[2] <= 65535
    assert plan.grid == (-(-s1 // plan.planes) * -(-s2 // plan.t2) * -(-s3 // plan.t3), c // plan.cb, b)
    assert 32 <= plan.threads <= TILE.max_threads and plan.smem <= min(SMEM_LIMIT, TILE.smem_limit) and plan.resident >= 1
    assert c % plan.cb == 0 and plan.cb * dt.itemsize % 16 == 0 and plan.t3 % TILE.run == 0
    assert plan.t2 % tile_rows(plan.ks[1]) == 0 and plan.cb % TILE.channels == 0
    if (tuple(shape), dt, dw) in FEW_WAVES:
        assert plan.waves < 2 and plan.planes == 1 and plan.threads < 128  # cut as far as it goes
    else:
        assert plan.waves >= 2


def test_plan_routes_by_shape():
    """The route is a function of the shape: a 2-D batch walks its rows, widths that no 16-byte vector divides
    take the run kernel, kernel sizes outside 1/3/5/7 along S2 or S3 take the run or per-output kernel."""
    two_d = conv_plan((16, 512, 512, 32), (7, 7), F32, SMS)
    assert two_d.shape == (16, 512, 1, 512, 32) and two_d.ks == (7, 1, 7) and two_d.t2 == 1
    assert conv_plan((2, 8, 8, 8, 6), (3, 3, 3), F32, SMS).route == "run"  # 6 % 4
    assert conv_plan((2, 8, 8, 8, 12), (3, 3, 3), BF16, SMS).route == "run"  # 12 % 8
    assert conv_plan((2, 8, 8, 8, 12), (3, 3, 3), F32, SMS).route == "tile"
    assert conv_plan((2, 32, 32, 32, 128), (3, 1, 9), F32, SMS).route == "any"
    assert conv_plan((2, 32, 32, 32, 128), (3, 9, 3), F32, SMS).route == "run"
    assert conv_plan((2, 32, 32, 32, 128), (9, 3, 3), F32, SMS).route == "tile"  # any odd k1
    assert conv_plan((2, 16, 16, 16, 32), (3, 5, 5), F32, SMS).route == "tile"
    assert conv_plan((2, 16, 16, 16, 32), (3, 5, 5), F32, SMS, dw=True).route == "run"  # 25 accumulators
    for dw in (False, True):
        plan = conv_plan((2, 32, 32, 32, 128), (3, 1, 9), F32, SMS, dw=dw)
        assert plan.blocks >= 1 and plan.grid[1] == 4


@pytest.mark.parametrize("dw", [False, True], ids=["fwd", "dw"])
def test_plan_of_a_named_route(dw):
    """``route=`` gives that route's plan on a shape that the tiled kernels would take, for chip_smoke.py's
    comparison of the routes; the run route refuses a k3 it is not compiled for."""
    shape = (2, 32, 32, 32, 30)
    assert conv_plan(shape, (3, 3, 3), F32, SMS, dw=dw).route == "run"
    tiled = (2, 32, 32, 32, 32)
    assert conv_plan(tiled, (3, 3, 3), F32, SMS, dw=dw).route == "tile"
    for route in ("run", "any"):
        plan = conv_plan(tiled, (3, 3, 3), F32, SMS, dw=dw, route=route)
        assert plan.route == route and plan.shape == tiled and plan.grid[1] == 1 and plan.blocks >= 1
    with pytest.raises(ValueError):
        conv_plan(tiled, (3, 1, 9), F32, SMS, dw=dw, route="run")
    with pytest.raises(ValueError):
        conv_plan(tiled, (3, 3, 3), F32, SMS, dw=dw, route="tile")


def test_resident_blocks_follow_the_launch_bounds():
    """The plan counts the blocks an SM holds from the registers that the kernels' launch bounds allow: 128 a
    thread (two blocks of 256 threads) but for a weight gradient of more than 9 accumulators a thread."""
    assert tile_min_blocks(3, 3, False) == tile_min_blocks(7, 7, False) == tile_min_blocks(3, 3, True) == 2
    assert tile_min_blocks(3, 5, True) == tile_min_blocks(5, 3, True) == 1
    assert tile_min_blocks(1, 7, True) == 2
    for shape, ks, dw, regs in (((2, 128, 128, 128, 32), (3, 3, 3), False, 128), ((2, 8, 8, 8, 512), (3, 3, 3), True, 128),
                                ((2, 32, 32, 32, 128), (1, 3, 5), True, 255)):
        plan = conv_plan(shape, ks, F32, SMS, dw=dw)
        warps = -(-plan.threads // 32)
        assert plan.resident == min(32, 2048 // (32 * warps), 65536 // (regs * 32 * warps), 233472 // (plan.smem + 1024))


def _kernel_view(x, ks, plan):
    """x and its taps as the kernel sees them: (B, S1, S2, S3, C) and (k1, k2, k3)."""
    return x.reshape(plan.shape), plan.ks


def _blocks(plan):
    """(block index along x, o2, o3, p0, p1) in the kernel's order: the S3 tile innermost."""
    b, s1, s2, s3, c = plan.shape
    tiles3, tiles2 = -(-s3 // plan.t3), -(-s2 // plan.t2)
    for bx in range(plan.grid[0]):
        o3, u = bx % tiles3 * plan.t3, bx // tiles3
        o2, p0 = u % tiles2 * plan.t2, u // tiles2 * plan.planes
        yield bx, o2, o3, p0, min(p0 + plan.planes, s1)


class _Ring:
    """The ring of k1 + 1 input planes in shared memory, each a flat buffer in ``tile_layout``'s places; the
    plane j1 of a walk from p0 sits in slot (j1 - p0 + r1) % (k1 + 1).  Loads record which plane a slot holds,
    and a read of a slot that holds another plane fails."""

    def __init__(self, x, b, c0, plan, o2, o3, rows, cols, elt=4):
        self.x, self.b, self.c0, self.cb, self.o2, self.o3 = x, b, c0, plan.cb, o2, o3
        self.rows, self.cols, self.elt = rows, cols, elt
        self.lay = tile_layout(rows, cols, plan.cb, elt)
        self.slots = [None] * (plan.ks[0] + 1)
        self.reads = []

    def load(self, slot, j1):
        col_bytes, pad, row_bytes, size = self.lay
        buf = torch.full((size // self.elt,), float("nan"), dtype=self.x.dtype)
        _, s1, s2, s3, _ = self.x.shape
        for r in range(self.rows):
            for c in range(self.cols):
                j2, j3 = self.o2 + r, self.o3 + c
                at = (r * row_bytes + c * col_bytes + c // 4 * pad) // self.elt
                inside = 0 <= j2 < s2 and 0 <= j3 < s3
                if inside:
                    self.reads.append((j1, j2, j3))
                buf[at:at + self.cb] = self.x[self.b, j1, j2, j3, self.c0:self.c0 + self.cb] if inside else 0.0
        self.slots[slot] = (j1, buf)

    def tile(self, slot, j1):
        """The slot's plane as (rows, cols, cb), read back through the layout."""
        held, buf = self.slots[slot]
        assert held == j1, f"slot {slot} holds plane {held}, read as {j1}"
        col_bytes, pad, row_bytes, _ = self.lay
        idx = torch.tensor([[(r * row_bytes + c * col_bytes + c // 4 * pad) // self.elt for c in range(self.cols)]
                            for r in range(self.rows)])
        return buf[idx[..., None] + torch.arange(self.cb)]


def _walk(plan, x, on_plane):
    """Drive the kernels' walk over every block: prologue planes p0 - r1 ... p0 + r1, then before each output
    plane i1 the prefetch of plane i1 + r1 + 1; ``on_plane(block, ring, i1)`` computes plane i1's part."""
    b_, s1, s2, s3, c = plan.shape
    k1, k2, k3 = plan.ks
    r1, slots = k1 // 2, k1 + 1
    for b in range(b_):
        for cy in range(plan.grid[1]):
            c0 = cy * plan.cb
            for bx, o2, o3, p0, p1 in _blocks(plan):
                ring = _Ring(x, b, c0, plan, o2 - k2 // 2, o3 - k3 // 2, plan.t2 + k2 - 1, plan.t3 + k3 - 1)
                for j1 in range(max(p0 - r1, 0), min(p0 + r1, s1 - 1) + 1):
                    ring.load((j1 - p0 + r1) % slots, j1)
                block = (b, c0, bx, o2, o3, p0, p1)
                for i1 in range(p0, p1):
                    nxt = i1 + r1 + 1
                    if i1 + 1 < p1 and nxt < s1:
                        ring.load((nxt - p0 + r1) % slots, nxt)
                    on_plane(block, ring, i1)
                # every read lies inside the block's halo box
                for j1, j2, j3 in ring.reads:
                    assert p0 - r1 <= j1 < p1 + r1 and o2 - k2 // 2 <= j2 < o2 + plan.t2 + k2 // 2
                    assert o3 - k3 // 2 <= j3 < o3 + plan.t3 + k3 // 2


def emulate_forward(x, w, ks, plan: ConvPlan):
    """The forward as the plan's blocks compute it, each from its ring of planes in the layout's places."""
    xv, (k1, k2, k3) = _kernel_view(x, ks, plan)
    _, s1, s2, s3, c = plan.shape
    r1, slots = k1 // 2, k1 + 1
    y = torch.zeros_like(xv)
    count = torch.zeros(xv.shape[:-1] + (c // plan.cb,), dtype=torch.int64)
    taps = w.reshape(w.shape[0], k1, k2, k3, c)

    def on_plane(block, ring, i1):
        b, c0, _, o2, o3, p0, _ = block
        acc = torch.zeros(plan.t2, plan.t3, plan.cb, dtype=xv.dtype)
        for a in range(k1):
            j1 = i1 + a - r1
            if not 0 <= j1 < s1:
                continue
            tile = ring.tile((j1 - p0 + r1) % slots, j1)
            for d in range(k2):
                for e in range(k3):
                    acc += taps[b, a, d, e, c0:c0 + plan.cb] * tile[d:d + plan.t2, e:e + plan.t3]
        n2, n3 = min(plan.t2, s2 - o2), min(plan.t3, s3 - o3)
        y[b, i1, o2:o2 + n2, o3:o3 + n3, c0:c0 + plan.cb] = acc[:n2, :n3]
        count[b, i1, o2:o2 + n2, o3:o3 + n3, c0 // plan.cb] += 1

    _walk(plan, xv, on_plane)
    assert bool((count == 1).all()), "an output was written other than once"
    return y.reshape(x.shape)


def emulate_dw(x, g, ks, plan: ConvPlan):
    """Each block's partial set (taps x cb), then the sample's sets added in block order."""
    xv, (k1, k2, k3) = _kernel_view(x, ks, plan)
    gv = g.reshape(plan.shape)
    b_, s1, s2, s3, c = plan.shape
    r1, slots = k1 // 2, k1 + 1
    partials = torch.zeros(b_, plan.grid[0], k1, k2, k3, c, dtype=xv.dtype)

    def on_plane(block, ring, i1):
        b, c0, bx, o2, o3, p0, _ = block
        gt = torch.zeros(plan.t2, plan.t3, plan.cb, dtype=xv.dtype)
        n2, n3 = min(plan.t2, s2 - o2), min(plan.t3, s3 - o3)
        gt[:n2, :n3] = gv[b, i1, o2:o2 + n2, o3:o3 + n3, c0:c0 + plan.cb]
        for a in range(k1):
            j1 = i1 + a - r1
            if not 0 <= j1 < s1:
                continue
            tile = ring.tile((j1 - p0 + r1) % slots, j1)
            for d in range(k2):
                for e in range(k3):
                    partials[b, bx, a, d, e, c0:c0 + plan.cb] += (gt * tile[d:d + plan.t2, e:e + plan.t3]).sum((0, 1))

    _walk(plan, xv, on_plane)
    dw = torch.zeros(b_, k1 * k2 * k3, c, dtype=xv.dtype)
    for p in range(plan.grid[0]):
        dw += partials[:, p].reshape(b_, -1, c)
    return dw


# (x shape, kernel size, SMs): small shapes whose plans cut the walk, the channels and the tile in turn, with
# tiles that the volume does not divide, a 2-D batch, a kernel of one tap along S2, and k1 = 5.
WALKS = [
    ((2, 6, 10, 13, 8), (3, 3, 3), 132),
    ((1, 9, 7, 6, 16), (3, 3, 3), 1),
    ((2, 5, 9, 11, 12), (3, 1, 3), 4),
    ((1, 7, 5, 9, 4), (5, 3, 1), 2),
    ((2, 9, 13, 8), (5, 3), 3),
    ((1, 11, 6, 8), (3, 7), 132),
]


def _walk_inputs(shape, ks, seed):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(*shape))
    w = torch.from_numpy(rs.randn(shape[0], math.prod(ks), shape[-1]))
    g = torch.from_numpy(rs.randn(*shape))
    return x, w, g


@pytest.mark.parametrize("shape,ks,sms", WALKS, ids=[f"{'x'.join(map(str, s))}-k{''.join(map(str, k))}-sm{n}" for s, k, n in WALKS])
def test_tile_walk_forward_matches_plain(shape, ks, sms):
    """In the model of the plan's walk: every output written once, every read inside the block's halo box, every
    ring slot read holding the plane it is read as, and the result the plain version's."""
    x, w, _ = _walk_inputs(shape, ks, sum(shape))
    plan = conv_plan(shape, ks, F32, sms)
    assert plan.route == "tile"
    y = emulate_forward(x, w, ks, plan)
    ref = depthwise_conv_plain(x, w, ks)
    assert ref.dtype == torch.float64
    torch.testing.assert_close(y, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape,ks,sms", WALKS, ids=[f"{'x'.join(map(str, s))}-k{''.join(map(str, k))}-sm{n}" for s, k, n in WALKS])
def test_tile_walk_dw_matches_plain(shape, ks, sms):
    """In the model of the plan's walk, the blocks' partial sets, added in block order, are the plain weight
    gradient."""
    x, _, g = _walk_inputs(shape, ks, sum(shape) + 1)
    plan = conv_plan(shape, ks, F32, sms, dw=True)
    assert plan.route == "tile"
    dw = emulate_dw(x, g, ks, plan)
    torch.testing.assert_close(dw, depthwise_conv_dw_plain(x, g, ks), rtol=1e-12, atol=1e-12)


def test_walks_cover_the_cuts():
    """The walks above exercise a walk cut along S1, channels split below the width, and partial tiles."""
    plans = [conv_plan(s, k, F32, n, dw=dw) for s, k, n in WALKS for dw in (False, True)]
    assert any(p.planes < p.shape[1] for p in plans)
    assert any(p.cb < p.shape[-1] for p in plans)
    assert any(p.shape[2] % p.t2 or p.shape[3] % p.t3 for p in plans)
    assert any(p.ks[0] == 5 for p in plans) and any(p.shape[2] == 1 for p in plans)
