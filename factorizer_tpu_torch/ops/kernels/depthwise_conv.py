"""K3: per-sample depthwise convolution and its weight gradient (``csrc/depthwise_conv.cu``, ``csrc/depthwise_conv_dw.cu``).

Counterpart of ``depthwise_conv3d_packed`` / ``depthwise_conv2d_packed`` in
``factorizer_tpu/ops/pallas/depthwise_packed.py`` and of ``depthwise_conv3d``
in ``factorizer_tpu/ops/pallas/depthwise_conv.py``, which compute one
function in two TPU layouts: on a channels-last volume ``x (B, S1, S2, S3, C)``
or image batch ``x (B, S1, S2, C)`` with per-sample taps ``w (B, taps, C)``,

    y[b, v, c] = sum_t w[b, t, c] * xpad[b, v + off_t, c]

with zero "same" padding, odd kernel sizes ``ks``, taps row-major over ``ks``
and cross-correlation orientation (as ``F.conv3d``).  Any channel count, any
odd ``ks``.  :func:`conv_plan` chooses from the shape how a call runs: the
tiled kernels (a halo tile in shared memory walked along the first spatial
axis; a 2-D batch as the ``(B, H, 1, W, C)`` view with kernel ``(kh, 1, kw)``)
for widths that a 16-byte vector divides and kernel sizes 1/3/5/7 along the
last two axes, otherwise a kernel with one channel a thread.

:func:`depthwise_conv` launches the forward kernel for a CUDA tensor and is
differentiable in ``x`` and ``w``: its backward launches the forward kernel on
the cotangent with spatially flipped taps (``dx``) and the weight-gradient
kernel (:func:`depthwise_conv_dw`), which sums per-block partial sums in block
order, so a gradient is the same from run to run.  A CPU tensor takes
:func:`depthwise_conv_plain`, a grouped ``F.conv{2,3}d`` that autograd
differentiates; :func:`depthwise_conv_dw_plain` is its weight gradient by name.
Both kernels accumulate in float32 for float32 or bfloat16 activations; the
taps and their gradient are float32.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from . import build

__all__ = ["depthwise_conv", "depthwise_conv_plain", "depthwise_conv_dw", "depthwise_conv_dw_plain", "flip_taps",
           "conv_plan", "ConvPlan", "TILE", "tile_min_blocks"]

# The kernels' routes (the C entries' `route`): the tiled kernels, the run kernels (any width, k3 in _RUN_K3), and
# the one-output-per-thread kernels (any other odd k3).  ``_RUN``, ``_WARPS`` and ``_ROWS`` mirror the run kernels.
ROUTES = ("tile", "run", "any")
_RUN_K3 = (1, 3, 5, 7)
_RUN, _WARPS, _ROWS = 8, 8, 9
_GRID_YZ = 65535
_TILE_K = (1, 3, 5, 7)  # kernel sizes along S2 and S3 that the tiled kernels are compiled for


class TileConstants(NamedTuple):
    """The constants of ``csrc/depthwise_conv.cuh`` that the plan mirrors; ``chip_smoke.py`` holds them against
    the library's ``ftt_depthwise_conv_tile_query``."""

    run: int  # kTileRun: outputs along S3 a thread
    channels: int  # kTileChannels: channels a thread
    max_threads: int  # kTileMaxThreads
    smem_limit: int  # kSmemLimit: 227 KB
    dw_taps: int  # kDwTileTaps: k2 * k3 at most, the accumulators a thread of the weight gradient holds


TILE = TileConstants(run=4, channels=4, max_threads=256, smem_limit=232448, dw_taps=16)
# What one SM of an H100 holds: shared memory, threads, blocks, registers.
_SM_SMEM, _SM_THREADS, _SM_BLOCKS, _SM_REGS = 233472, 2048, 32, 65536
# The plan's starting block: 16 channels, 8 rows and as many columns as make 128 threads forward (8 x 32 at 3^3)
# or 256 with the weight gradient's k1 tap planes (8 x 16).  Then the plan cuts it down to two waves, never below
# two warps.  On an H100 this came within a few per cent of the best plan of a sweep at the two largest stage
# shapes, which take most of the time; at (2,16^3,256) one wave of whole 16 x 16 planes measured faster.
_TILE_CHANNELS_START = 16
_TARGET_THREADS = {False: 128, True: 256}
_MIN_THREADS = 64
_TARGET_WAVES = 2


def tile_min_blocks(k2: int, k3: int, dw: bool) -> int:
    """The tiled kernel's ``__launch_bounds__`` blocks (``ftt::tile_min_blocks``): its registers a thread are at
    most ``65536 / (256 * blocks)``."""
    return 1 if dw and k2 * k3 > 9 else 2


class ConvPlan(NamedTuple):
    """How one K3 call runs: the route, the shapes as the kernel sees them, and for the tiled route the tile
    (``t2`` rows x ``t3`` columns of a plane), the channels per block ``cb`` and the planes per block along S1,
    with what follows from them (threads and shared memory per block, the grid, the blocks one SM holds and the
    waves of blocks on the card)."""

    route: str
    shape: tuple[int, int, int, int, int]
    ks: tuple[int, int, int]
    t2: int
    t3: int
    cb: int
    planes: int
    threads: int
    smem: int
    grid: tuple[int, int, int]
    resident: int
    waves: float

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)

    def describe(self) -> str:
        if self.route != "tile":
            return f"{self.route} kernel, {self.blocks} blocks, {self.waves:.2f} waves"
        return (f"tile {self.t2}x{self.t3} x {self.cb} ch ({TILE.channels} a thread), {self.planes} planes a block, "
                f"{self.threads} threads, {self.blocks} blocks, {self.waves:.2f} waves, {self.smem / 1024:.1f} KB")


def tile_rows(k2: int) -> int:
    """Rows along S2 that a thread of a tiled kernel computes."""
    return 2 if k2 > 1 else 1


def tile_layout(rows: int, cols: int, cb: int, elt: int) -> tuple[int, int, int, int]:
    """``(col_bytes, pad, row_bytes, bytes)`` of a tile in shared memory, as ``ftt::TileLayout``: position
    ``(row, col)`` starts at ``row * row_bytes + col * col_bytes + (col // 4) * pad``."""
    col_bytes = cb * elt
    pad = col_bytes if col_bytes < 128 else 0
    row_bytes = cols * col_bytes + -(-cols // TILE.run) * pad
    return col_bytes, pad, row_bytes, rows * row_bytes


def tile_threads(t2: int, t3: int, cb: int, ks: tuple[int, int, int], dw: bool) -> int:
    return cb // TILE.channels * (t3 // TILE.run) * (t2 // tile_rows(ks[1])) * (ks[0] if dw else 1)


def tile_smem(t2: int, t3: int, cb: int, ks: tuple[int, int, int], elt: int, dw: bool) -> int:
    """Shared memory of a tiled block, as ``ftt::tile_smem``."""
    k1, k2, k3 = ks
    ring = (k1 + 1) * tile_layout(t2 + k2 - 1, t3 + k3 - 1, cb, elt)[3]
    if not dw:
        return -(-k1 * k2 * k3 * cb * 4 // 16) * 16 + ring
    walk = ring + 2 * tile_layout(t2, t3, cb, elt)[3]
    return max(walk, tile_threads(t2, t3, cb, ks, True) * k2 * k3 * TILE.channels * 4)


def _resident(threads: int, smem: int, ks: tuple[int, int, int], dw: bool) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes that one SM holds, at the registers a thread that the
    kernel's launch bounds allow (fewer where ptxas takes fewer: then this counts low)."""
    warps = -(-threads // 32)
    regs = min(255, _SM_REGS // (TILE.max_threads * tile_min_blocks(ks[1], ks[2], dw)))
    return max(0, min(_SM_BLOCKS, _SM_THREADS // (32 * warps), _SM_REGS // (regs * 32 * warps),
                      _SM_SMEM // (smem + 1024)))


def _pow2_at_most(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def _tile_plan(shape, ks, elt: int, sms: int, dw: bool) -> ConvPlan | None:
    b, s1, s2, s3, c = shape
    k1, k2, k3 = ks
    q = tile_rows(k2)
    cb = max(_pow2_at_most(min(c, _TILE_CHANNELS_START)), 16 // elt)
    while c % cb:
        cb //= 2
    t2 = min(8, -(-s2 // q) * q)
    per_run = cb // TILE.channels * (t2 // q) * (k1 if dw else 1)
    t3 = TILE.run * max(1, min(_pow2_at_most(-(-s3 // TILE.run)), _pow2_at_most(_TARGET_THREADS[dw] // per_run)))
    planes = s1

    def make(t2, t3, cb, planes):
        threads, smem = tile_threads(t2, t3, cb, ks, dw), tile_smem(t2, t3, cb, ks, elt, dw)
        grid = (-(-s1 // planes) * -(-s2 // t2) * -(-s3 // t3), c // cb, b)
        resident = _resident(threads, smem, ks, dw)
        waves = math.prod(grid) / (sms * resident) if resident else 0.0
        return ConvPlan("tile", shape, ks, t2, t3, cb, planes, threads, smem, grid, resident, waves)

    plan = make(t2, t3, cb, planes)
    while plan.waves < _TARGET_WAVES:
        # Cut the walk along S1, then the channels, then the tile's columns and rows, never below two warps.
        if planes > 1:
            planes = -(-planes // 2)
        elif cb * elt > 16 and cb // 2 >= TILE.channels and plan.threads // 2 >= _MIN_THREADS:
            cb //= 2
        elif t3 > TILE.run and plan.threads // 2 >= _MIN_THREADS:
            t3 //= 2
        elif t2 > q and plan.threads // 2 >= _MIN_THREADS:
            t2 = max(q, t2 // 2 // q * q)
        else:
            break
        plan = make(t2, t3, cb, planes)
    # The limits of the kernel (tile_plan_ok): a plan that breaks one takes the run kernel instead.
    if plan.threads > TILE.max_threads or plan.smem > TILE.smem_limit or plan.grid[0] >= 2**31 or plan.grid[1] > _GRID_YZ:
        return None
    return plan


def conv_plan(shape: Sequence[int], ks: Sequence[int], dtype: torch.dtype, sms: int, dw: bool = False,
              route: str | None = None) -> ConvPlan:
    """The launch plan of :func:`depthwise_conv` (``dw=False``) or :func:`depthwise_conv_dw` on an input of
    ``shape`` and ``dtype`` with kernel ``ks``, on a card of ``sms`` SMs.  Chosen from the shape alone.

    The tiled route takes k2, k3 in (1, 3, 5, 7) (for dw also k2 * k3 <= 16), any odd k1, and a channel count
    that a 16-byte vector divides (4 f32 or 8 bf16 channels).  A 2-D batch runs as ``(B, H, 1, W, C)`` with
    kernel ``(kh, 1, kw)``, so that the block walks down the image rows.  Other shapes take the run kernel
    (k3 in (1, 3, 5, 7)) or the one-output-per-thread kernel.  ``route="run"`` or ``"any"`` gives the plan of that
    route instead, for a comparison of the routes on one shape; the wrappers never pass it."""
    if route not in (None, "run", "any"):
        raise ValueError(f"route must be None, 'run' or 'any', got {route!r}")
    return _conv_plan(tuple(int(n) for n in shape), tuple(int(k) for k in ks), dtype, int(sms), bool(dw), route)


@functools.lru_cache(maxsize=None)
def _conv_plan(shape: tuple[int, ...], ks: tuple[int, ...], dtype: torch.dtype, sms: int, dw: bool,
               route: str | None = None) -> ConvPlan:
    b, *spatial, c = shape
    if len(ks) == 2:
        spatial, ks = [1, *spatial], (1, *ks)
    if math.prod(spatial) >= 2**31 or b > _GRID_YZ:
        raise ValueError(f"the kernels take fewer than 2^31 voxels per sample and a batch up to {_GRID_YZ}")
    elt = torch.tensor([], dtype=dtype).element_size()
    view, kview = (b, *spatial, c), ks
    if spatial[0] == 1 and ks[0] == 1:
        view, kview = (b, spatial[1], 1, spatial[2], c), (ks[1], 1, ks[2])
    if (route is None and kview[1] in _TILE_K and kview[2] in _TILE_K and c % (16 // elt) == 0
            and (not dw or kview[1] * kview[2] <= TILE.dw_taps)):
        plan = _tile_plan(view, kview, elt, sms, dw)
        if plan is not None:
            return plan
    s1, s2, s3 = spatial
    lanes = -(-c // 32)
    if route is None:
        route = "run" if ks[2] in _RUN_K3 else "any"
    if route == "run":
        if ks[2] not in _RUN_K3:
            raise ValueError(f"the run kernels take k3 in {_RUN_K3}, got {ks}")
        items, per_sample = s1 * s2 * -(-s3 // _RUN), -(-ks[0] * ks[1] // _ROWS)
    else:
        items, per_sample = s1 * s2 * s3, math.prod(ks)
    if not dw:
        grid = (-(-items // _WARPS), lanes, b)
    else:
        if b * per_sample > _GRID_YZ:
            raise ValueError(f"batch {b} with kernel {ks} exceeds the weight-gradient kernel's grid")
        # Blocks per sample: enough to fill the card a few times over, at most one per group of work items.
        grid = (max(1, min(-(-items // _WARPS), -(-4 * sms // (lanes * b * per_sample)))), lanes, b * per_sample)
    resident = _SM_THREADS // 256
    return ConvPlan(route, (b, *spatial, c), ks, 0, 0, 0, 0, 256, 0, grid, resident, math.prod(grid) / (sms * resident))


def _plan_args(plan: ConvPlan, dw: bool) -> tuple[int, ...]:
    """The C entry's shape, kernel, route and plan arguments (for the weight gradient also the partial sets per
    sample)."""
    args = (*plan.shape, *plan.ks, ROUTES.index(plan.route), plan.t2, plan.t3, plan.cb, plan.planes)
    return args + ((plan.grid[0],) if dw else ())


@functools.lru_cache(maxsize=None)
def _launch_args(shape: tuple[int, ...], ks: tuple[int, ...], dtype: torch.dtype, sms: int,
                 dw: bool) -> tuple[bool, tuple[int, ...]]:
    """Whether the shape's plan takes the tiled route, and :func:`_plan_args`."""
    plan = _conv_plan(shape, ks, dtype, sms, dw)
    return plan.route == "tile", _plan_args(plan, dw)


def _sms(t: torch.Tensor) -> int:
    return _sm_count(t.device.index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_ks(x: torch.Tensor, ks: Sequence[int]) -> tuple[int, ...]:
    ks = tuple(int(k) for k in ks)
    if x.ndim not in (4, 5) or len(ks) != x.ndim - 2:
        raise ValueError(f"expected (B, S1, S2, C) or (B, S1, S2, S3, C) and a kernel size per spatial axis, "
                         f"got shape {tuple(x.shape)} and ks {ks}")
    if any(k < 1 or k % 2 == 0 for k in ks):
        raise ValueError(f"'same' padding needs odd kernel sizes, got {ks}")
    return ks


def flip_taps(w: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """The taps ``(B, taps, C)`` flipped along every kernel axis: the adjoint correlation's taps."""
    b, taps, c = w.shape
    return w.reshape(b, *ks, c).flip(tuple(range(1, 1 + len(ks)))).reshape(b, taps, c)


def depthwise_conv_plain(x: torch.Tensor, w: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """The plain PyTorch version: one grouped convolution over the ``(1, B*C, *S)`` view, in float32
    (float64 stays float64, for semantic checks), cast back to ``x``'s dtype."""
    ks = _check_ks(x, ks)
    b, *spatial, c = x.shape
    if tuple(w.shape) != (b, math.prod(ks), c):
        raise ValueError(f"taps of shape {(b, math.prod(ks), c)} expected, got {tuple(w.shape)}")
    dt = torch.promote_types(x.dtype, torch.float32)
    conv = F.conv2d if len(ks) == 2 else F.conv3d
    xs = x.to(dt).movedim(-1, 1).reshape(1, b * c, *spatial)
    weight = w.to(dt).transpose(1, 2).reshape(b * c, 1, *ks)
    y = conv(xs, weight, None, 1, tuple(k // 2 for k in ks), 1, b * c)
    return y.reshape(b, c, *spatial).movedim(1, -1).contiguous().to(x.dtype)


def depthwise_conv_dw_plain(x: torch.Tensor, g: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """``dw (B, taps, C)`` for the cotangent ``g`` of the output: autograd through :func:`depthwise_conv_plain`."""
    ks = _check_ks(x, ks)
    dt = torch.promote_types(x.dtype, torch.float32)
    with torch.enable_grad():
        w = torch.zeros(x.shape[0], math.prod(ks), x.shape[-1], dtype=dt, device=x.device, requires_grad=True)
        y = depthwise_conv_plain(x.detach().to(dt), w, ks)
        (dw,) = torch.autograd.grad(y, w, g.to(dt))
    return dw


def _check_tensor(t: torch.Tensor, like: torch.Tensor, name: str) -> None:
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor of x's shape, dtype and device")


def _launch_forward(x: torch.Tensor, w: torch.Tensor, ks: tuple[int, ...], plan: ConvPlan | None = None) -> torch.Tensor:
    """The forward kernel on a CUDA tensor, with the shape's plan or ``plan`` (of :func:`conv_plan`)."""
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if plan is None:
        tiled, args = _launch_args(tuple(x.shape), ks, x.dtype, _sms(x), False)
    else:
        tiled, args = plan.route == "tile", _plan_args(plan, False)
    if tuple(w.shape) != (x.shape[0], math.prod(ks), x.shape[-1]) or w.device != x.device:
        raise ValueError(f"taps of shape {(x.shape[0], math.prod(ks), x.shape[-1])} on {x.device} expected, "
                         f"got {tuple(w.shape)} on {w.device}")
    if tiled:
        build.check_aligned("x", x)
    wf = w if w.dtype == torch.float32 and w.is_contiguous() else w.float().contiguous()
    y = torch.empty_like(x)
    status = build.library().ftt_depthwise_conv(
        x.data_ptr(), wf.data_ptr(), y.data_ptr(), build.dtype_code(x.dtype), *args, build.stream_of(x),
    )
    build.check(status, "depthwise_conv")
    depthwise_conv.launches += 1
    return y


def _launch_dw(x: torch.Tensor, g: torch.Tensor, ks: tuple[int, ...], plan: ConvPlan | None = None) -> torch.Tensor:
    """The weight-gradient kernel on CUDA tensors, with the shape's plan or ``plan`` (of :func:`conv_plan`)."""
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _check_tensor(g, x, "g")
    if plan is None:
        tiled, args = _launch_args(tuple(x.shape), ks, x.dtype, _sms(x), True)
    else:
        tiled, args = plan.route == "tile", _plan_args(plan, True)
    if tiled:
        build.check_aligned("x", x)
        build.check_aligned("g", g)
    b, taps, c = x.shape[0], math.prod(ks), x.shape[-1]
    # args[-1]: partial sets per sample, the tiled grid's blocks a sample or the run grid's x
    partials = torch.empty(b, args[-1], taps, c, dtype=torch.float32, device=x.device)
    dw = torch.empty(b, taps, c, dtype=torch.float32, device=x.device)
    status = build.library().ftt_depthwise_conv_dw(
        x.data_ptr(), g.data_ptr(), partials.data_ptr(), dw.data_ptr(), build.dtype_code(x.dtype), *args,
        build.stream_of(x),
    )
    build.check(status, "depthwise_conv_dw")
    depthwise_conv_dw.launches += 1
    return dw


def depthwise_conv_dw(x: torch.Tensor, g: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """``dw (B, taps, C)``, float32, of :func:`depthwise_conv` for the cotangent ``g``.

    The weight-gradient kernel on the card, plain on the CPU.  ``g`` has
    ``x``'s shape and dtype.
    """
    ks = _check_ks(x, ks)
    if not build.launches_kernel(x):
        return depthwise_conv_dw_plain(x, g, ks)
    return _launch_dw(x, g, ks)


depthwise_conv_dw.launches = 0


class _DepthwiseConv(torch.autograd.Function):
    """The kernels under autograd: forward saves ``x`` and ``w``; ``dx`` is the forward kernel on flipped taps."""

    @staticmethod
    def forward(ctx, x, w, ks):
        ctx.save_for_backward(x, w)
        ctx.ks = ks
        return _launch_forward(x, w, ks)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        _check_tensor(g, x, "the cotangent")
        dx = _launch_forward(g, flip_taps(w, ctx.ks), ctx.ks) if ctx.needs_input_grad[0] else None
        dw = depthwise_conv_dw(x, g, ctx.ks).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """Depthwise "same" correlation of ``x (B, *S, C)`` with per-sample taps ``w (B, taps, C)``; K3 on the
    card, plain on the CPU.

    Returns a tensor of ``x``'s shape and dtype, differentiable in ``x`` and
    ``w``.  ``launches`` counts the forward kernel's launches, those that
    compute ``dx`` in a backward pass included.
    """
    ks = _check_ks(x, ks)
    if not build.launches_kernel(x):
        return depthwise_conv_plain(x, w, ks)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _DepthwiseConv.apply(x, w, ks)
    return _launch_forward(x, w, ks)  # no graph to record: the launch without the autograd function's cost


depthwise_conv.launches = 0
