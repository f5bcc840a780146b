"""K5: shifted-window rank-1 NMF mixing of a volume cut into slabs along its first spatial axis
(``csrc/windowed_nmf_slab.cu``, ``csrc/windowed_nmf_slab_bwd.cu``).

Counterpart of ``windowed_nmf_multi_spatial`` in
``factorizer_tpu/ops/pallas/windowed_sharded.py``: K1's function
(:mod:`.windowed_nmf`) on ``(B, S1, S2, S3, C)`` where S1 is cut into ``n``
equal slabs of ``L = S1 / n`` rows, a multiple of the patch, over a ring of
processes.  Per shift ``(s1, s2, s3)`` a slab's first window row covers the
rows ``[-s1, p - s1)``, so

1. the left neighbour's last ``s1`` rows arrive as a *halo* (one exchange
   forward along the ring);
2. one kernel launch computes the pass on the slab: it reads rows below 0
   from the halo, writes the rows ``[0, L - s1)`` into the sum over passes
   and the values for the left neighbour's rows into a *send* buffer (f32);
3. the send buffers travel backward along the ring and a second, small
   kernel adds what arrives into the rows ``[L - s1, L)``.

A shift with ``s1 = 0`` exchanges nothing.  The backward does the same with
``x`` and the cotangent ``g`` both given a halo, and routes ``dx`` rows.
``u0`` and ``v0`` get no gradient.  The result equals K1 on the gathered
volume: bit for bit on the card (the routed rows are f32 and the passes sum
in the same order), to the last bits in the plain versions.

:func:`windowed_nmf_multi_spatial` is the entry point for one slab per
process (``torch.distributed`` carries the halos);
:func:`windowed_nmf_multi_spatial_local` holds a whole ring's slabs in one
process and differs from it in the exchange alone.  Both are one
``torch.autograd.Function`` whose backward launches the backward kernel.
CPU tensors take the plain passes; :func:`windowed_nmf_multi_spatial_plain`
is the plain PyTorch version of the whole ring, which autograd differentiates.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch

from ...parallel.collectives import ring_exchange
from . import build
from .windowed_nmf import EPS, _check, _norm_shift, windowed_nmf_backward_plain, windowed_nmf_plain

__all__ = [
    "windowed_nmf_multi_spatial", "windowed_nmf_multi_spatial_local", "windowed_nmf_multi_spatial_plain",
    "windowed_nmf_slab_pass", "windowed_nmf_slab_pass_plain",
    "windowed_nmf_slab_backward_pass", "windowed_nmf_slab_backward_pass_plain", "windowed_nmf_slab_tail", "SlabSum",
]

# (tensors handed over, forward along the ring or backward) -> what arrives, slab for slab.
Exchange = Callable[[list, bool], list]


class SlabSum:
    """One slab's sum over the shift passes, kept as K1's ``store_pass`` keeps it.

    The first pass starts the f32 scratch ``acc``, the middle ones add to it
    and the last scales the sum by ``1 / n`` and casts it into ``out``; with a
    single pass there is no scratch.  ``i`` counts the completed passes.  A
    pass visits every element of the slab exactly once: the rows
    ``[0, L - s1)`` in the pass's own launch, the rest in
    :func:`windowed_nmf_slab_tail`.
    """

    def __init__(self, like: torch.Tensor, n_passes: int) -> None:
        self.n, self.i = n_passes, 0
        self.out = torch.empty_like(like)
        wide = torch.promote_types(like.dtype, torch.float32)
        self.acc = torch.empty(like.shape, dtype=wide, device=like.device) if n_passes > 1 else None

    @property
    def first(self) -> bool:
        return self.i == 0

    @property
    def last(self) -> bool:
        return self.i == self.n - 1

    def put(self, rows: slice, y: torch.Tensor) -> None:
        """The plain version of ``store_pass`` on the rows ``rows``."""
        if self.first and self.last:
            self.out[:, rows] = y.to(self.out.dtype)
        elif self.first:
            self.acc[:, rows] = y
        elif not self.last:
            self.acc[:, rows] += y
        else:
            self.out[:, rows] = ((self.acc[:, rows] + y) / self.n).to(self.out.dtype)


def _padded(x: torch.Tensor, halo: Optional[torch.Tensor], s1: int) -> torch.Tensor:
    """The slab rolled by ``+s1`` along dim 1, in at least f32: the halo in front of the rows ``[0, L - s1)``."""
    wide = torch.promote_types(x.dtype, torch.float32)
    if not s1:
        return x.to(wide)
    return torch.cat([halo.to(wide), x[:, : x.shape[1] - s1].to(wide)], 1)


def windowed_nmf_slab_pass_plain(x, halo, u0, v0, head_dim: int, patch: int, shift: tuple, solver: str = "hals",
                                 num_iters: int = 5, eps: float = EPS, num_grad_steps: Optional[int] = None):
    """One shift pass on one slab in plain PyTorch: ``(y, send)``, both in at least f32.

    Concatenates the halo, solves the padded slab as :func:`windowed_nmf_plain`
    does (dims 2 and 3 are whole and roll in place) and splits the result:
    ``y`` is the pass on the slab's rows ``[0, L - s1)``, ``send`` on the left
    neighbour's last ``s1`` rows (None when ``s1 = 0``).  Differentiable.
    """
    s1, s2, s3 = shift
    ys = windowed_nmf_plain(_padded(x, halo, s1), u0, v0, head_dim, patch, ((0, s2, s3),), solver, num_iters, eps,
                            num_grad_steps)
    return (ys[:, s1:], ys[:, :s1]) if s1 else (ys, None)


def windowed_nmf_slab_backward_pass_plain(x, g, x_halo, g_halo, u0, v0, head_dim: int, patch: int, shift: tuple,
                                          solver: str = "hals", num_iters: int = 5, eps: float = EPS,
                                          num_grad_steps: Optional[int] = None):
    """One shift pass of the backward on one slab in plain PyTorch: ``(dx, send)`` as in the forward pass."""
    s1, s2, s3 = shift
    dxs = windowed_nmf_backward_plain(_padded(x, x_halo, s1), _padded(g, g_halo, s1), u0, v0, head_dim, patch,
                                      ((0, s2, s3),), solver, num_iters, eps, num_grad_steps)
    return (dxs[:, s1:], dxs[:, :s1]) if s1 else (dxs, None)


def _check_slab(x, others, halos, u0, v0, head_dim: int, patch: int, s1: int, solver: str) -> None:
    """Raise on what the slab kernels do not take."""
    if x.ndim == 5 and x.shape[1] % patch:
        raise ValueError(f"a slab of {x.shape[1]} rows is no multiple of the patch {patch}: cut S1 so that every "
                         "slab holds whole windows")
    _check(x, u0, v0, head_dim, patch, solver)
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError("g must be a contiguous tensor of x's shape, dtype and device")
    want = (x.shape[0], s1, *x.shape[2:])
    for h in halos if s1 else ():
        if h is None or tuple(h.shape) != want or h.dtype != x.dtype or h.device != x.device or not h.is_contiguous():
            raise ValueError(f"a shift of {s1} rows needs a contiguous halo of shape {want}, dtype {x.dtype}, on {x.device}")


def _launch(entry: str, count: str, tensors, halos, total: SlabSum, u0, v0, head_dim, patch, shift, solver,
            num_iters, eps, extra=()):
    """One launch of a slab kernel: the rows ``[0, L - s1)`` into ``total``; returns the f32 send buffer (None at s1 = 0)."""
    x, s1 = tensors[0], shift[0]
    _check_slab(x, tensors[1:], halos, u0, v0, head_dim, patch, s1, solver)
    for name, t in (*(("a slab", t) for t in tensors), *((("a halo", h) for h in halos) if s1 else ())):
        build.check_aligned(name, t)
    send = torch.empty((x.shape[0], s1, *x.shape[2:]), dtype=torch.float32, device=x.device) if s1 else None
    u0f = u0.detach().reshape(-1).float().contiguous()
    v0f = v0.detach().reshape(-1).float().contiguous()
    status = getattr(build.library(), entry)(
        *(t.data_ptr() for t in tensors), *(h.data_ptr() if s1 else None for h in halos),
        None if total.acc is None else total.acc.data_ptr(), total.out.data_ptr(), send.data_ptr() if s1 else None,
        u0f.data_ptr(), v0f.data_ptr(), build.dtype_code(x.dtype), *x.shape, head_dim, patch, *shift,
        int(solver == "mu"), num_iters, *extra, eps, int(total.first), int(total.last), 1.0 / total.n,
        build.stream_of(x),
    )
    build.check(status, entry)
    setattr(windowed_nmf_multi_spatial, count, getattr(windowed_nmf_multi_spatial, count) + 1)
    return send


def windowed_nmf_slab_pass(x, halo, total: SlabSum, u0, v0, head_dim: int, patch: int, shift: tuple,
                           solver: str = "hals", num_iters: int = 5, eps: float = EPS):
    """One shift pass on one slab, local: the forward slab kernel on the card, the plain pass on the CPU.

    ``x (B, L, S2, S3, C)`` is the slab, ``halo (B, s1, S2, S3, C)`` the left
    neighbour's last ``s1`` rows (None when ``s1 = 0``), ``shift`` a 3-tuple
    in ``[0, patch)``.  The pass's rows ``[0, L - s1)`` go into ``total``;
    returned is the send buffer for the left neighbour, ``(B, s1, S2, S3, C)``
    in f32, or None.  :func:`windowed_nmf_slab_tail` completes the pass.
    """
    if not build.launches_kernel(x):
        y, send = windowed_nmf_slab_pass_plain(x, halo, u0, v0, head_dim, patch, shift, solver, num_iters, eps)
        total.put(slice(0, x.shape[1] - shift[0]), y)
        return send
    return _launch("ftt_windowed_nmf_slab_shift", "launches", (x,), (halo,), total, u0, v0, head_dim, patch, shift,
                   solver, num_iters, eps)


def windowed_nmf_slab_backward_pass(x, g, x_halo, g_halo, total: SlabSum, u0, v0, head_dim: int, patch: int,
                                    shift: tuple, solver: str = "hals", num_iters: int = 5, eps: float = EPS,
                                    grad_steps: int = 5):
    """One shift pass of ``dx`` on one slab, local: the backward slab kernel on the card, plain on the CPU.

    As :func:`windowed_nmf_slab_pass`, with the cotangent ``g`` and its halo
    beside ``x`` and its halo; ``grad_steps`` in ``[1, num_iters]`` is the
    number of trailing iterations differentiated.
    """
    if not build.launches_kernel(x):
        dx, send = windowed_nmf_slab_backward_pass_plain(x, g, x_halo, g_halo, u0, v0, head_dim, patch, shift, solver,
                                                         num_iters, eps, grad_steps)
        total.put(slice(0, x.shape[1] - shift[0]), dx)
        return send
    return _launch("ftt_windowed_nmf_slab_shift_bwd", "backward_launches", (x, g), (x_halo, g_halo), total, u0, v0,
                   head_dim, patch, shift, solver, num_iters, eps, extra=(grad_steps,))


def windowed_nmf_slab_tail(total: SlabSum, recv: Optional[torch.Tensor], s1: int) -> None:
    """Complete a pass: the slab's last ``s1`` rows are what arrived from the right neighbour, ``recv (B, s1, S2, S3, C)``."""
    out = total.out
    if s1 and not build.launches_kernel(out):
        total.put(slice(out.shape[1] - s1, out.shape[1]), recv)
    elif s1:
        want = (out.shape[0], s1, *out.shape[2:])
        if tuple(recv.shape) != want or recv.dtype != torch.float32 or recv.device != out.device or not recv.is_contiguous():
            raise ValueError(f"the routed rows must be a contiguous float32 tensor of shape {want} on {out.device}")
        entry = "ftt_windowed_nmf_slab_tail"
        status = getattr(build.library(), entry)(
            recv.data_ptr(), None if total.acc is None else total.acc.data_ptr(), out.data_ptr(),
            build.dtype_code(out.dtype), out.shape[0], out.shape[1], out[0, 0].numel(), s1,
            int(total.first), int(total.last), 1.0 / total.n, build.stream_of(out),
        )
        build.check(status, entry)
        windowed_nmf_multi_spatial.tail_launches += 1
    total.i += 1


def _passes(xs, gs, exchange: Exchange, u0, v0, head_dim, patch, shifts, solver, num_iters, eps, grad_steps):
    """Every shift pass on the slabs this process holds (``gs`` None: the forward; else ``dx`` for the cotangents)."""
    if len({(x.shape, x.dtype, x.device) for x in xs}) != 1:
        raise ValueError("the slabs of a ring must share one shape, dtype and device")

    def travel(tensors: list, forward: bool) -> list:
        windowed_nmf_multi_spatial.bytes_sent += sum(t.numel() * t.element_size() for t in tensors)
        return exchange(tensors, forward)

    totals = [SlabSum(x, len(shifts)) for x in xs]
    nothing = [None] * len(xs)
    for shift in shifts:
        sh = _norm_shift(shift, patch)
        s1 = sh[0]

        def halos_of(tensors) -> list:
            return travel([t[:, t.shape[1] - s1:].contiguous() for t in tensors], True) if s1 else nothing

        x_halos = halos_of(xs)
        if gs is None:
            sends = [windowed_nmf_slab_pass(x, h, total, u0, v0, head_dim, patch, sh, solver, num_iters, eps)
                     for x, h, total in zip(xs, x_halos, totals)]
        else:
            sends = [windowed_nmf_slab_backward_pass(x, g, xh, gh, total, u0, v0, head_dim, patch, sh, solver,
                                                     num_iters, eps, grad_steps)
                     for x, g, xh, gh, total in zip(xs, gs, x_halos, halos_of(gs), totals)]
        for total, recv in zip(totals, travel(sends, False) if s1 else nothing):
            windowed_nmf_slab_tail(total, recv, s1)
    return [total.out for total in totals]


class _SpatialNMF(torch.autograd.Function):
    """The slab passes under autograd: forward saves the slabs alone; ``u0`` and ``v0`` get no gradient.

    The backward always runs every pass and every exchange, whichever inputs
    need a gradient: the processes of a ring must enter the same exchanges in
    the same order.
    """

    @staticmethod
    def forward(ctx, exchange, config, u0, v0, *slabs):
        ctx.exchange, ctx.config = exchange, config
        ctx.save_for_backward(u0, v0, *slabs)
        return tuple(_passes(slabs, None, exchange, u0, v0, *config[:-1], None))

    @staticmethod
    def backward(ctx, *gs):
        u0, v0, *slabs = ctx.saved_tensors
        *config, num_grad_steps = ctx.config
        num_iters = config[4]
        grad_steps = num_iters if num_grad_steps is None else max(min(num_grad_steps, num_iters), 0)
        if grad_steps == 0:
            dxs = [torch.zeros_like(x) for x in slabs]  # every iteration saw a detached x
        else:
            dxs = _passes(slabs, [g.contiguous() for g in gs], ctx.exchange, u0, v0, *config, grad_steps)
        return (None, None, None, None, *dxs)


def _local_ring(tensors: list, forward: bool) -> list:
    """The ring held in one process: slab ``i`` receives from ``i - 1`` (forward) or ``i + 1``."""
    n, step = len(tensors), 1 if forward else -1
    return [tensors[(i - step) % n] for i in range(n)]


def _process_ring(tensors: list, forward: bool, mesh, axis: str) -> list:
    return [ring_exchange(t, mesh, axis, forward) for t in tensors]


def windowed_nmf_multi_spatial_local(
    slabs: Sequence[torch.Tensor],
    u0: torch.Tensor,
    v0: torch.Tensor,
    head_dim: int,
    patch: int,
    shifts: Sequence = (None,),
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
) -> list[torch.Tensor]:
    """K5 on all slabs of a ring held in one process, halos wired by hand; differentiable in the slabs.

    ``slabs[i]`` is ``x[:, i * L:(i + 1) * L]`` of the volume, contiguous.
    Every line but the exchange is that of :func:`windowed_nmf_multi_spatial`.
    """
    config = (head_dim, patch, tuple(shifts), solver, num_iters, eps, num_grad_steps)
    return list(_SpatialNMF.apply(_local_ring, config, u0, v0, *slabs))


def windowed_nmf_multi_spatial(
    x_local: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    head_dim: int,
    patch: int,
    shifts: Sequence = (None,),
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
    *,
    mesh,
    axis_name: str = "model",
) -> torch.Tensor:
    """Shifted-window NMF mixing of a volume whose first spatial axis is cut over ``axis_name`` of ``mesh``.

    ``x_local (B, L, S2, S3, C)`` is this process's slab, the
    ``mesh.axis_index(axis_name)``-th of ``mesh.axis_size(axis_name)``; ``L``
    must be a multiple of ``patch``.  Returns the mixed slab, differentiable
    in ``x_local``.  Collective over the axis, in the backward too: every
    process of the ring calls it, and calls ``backward``, in the same order.
    The slab kernels on the card, the plain passes on the CPU.
    """
    config = (head_dim, patch, tuple(shifts), solver, num_iters, eps, num_grad_steps)
    exchange = functools.partial(_process_ring, mesh=mesh, axis=axis_name)
    return _SpatialNMF.apply(exchange, config, u0, v0, x_local)[0]


# Launches of the forward and the backward slab kernel (one per shift and slab), of the small kernel that adds the
# routed rows, and the bytes handed to the exchange (halos in the slab's dtype, routed rows in f32).
windowed_nmf_multi_spatial.launches = 0
windowed_nmf_multi_spatial.backward_launches = 0
windowed_nmf_multi_spatial.tail_launches = 0
windowed_nmf_multi_spatial.bytes_sent = 0


def windowed_nmf_multi_spatial_plain(
    slabs: Sequence[torch.Tensor],
    u0: torch.Tensor,
    v0: torch.Tensor,
    head_dim: int,
    patch: int,
    shifts: Sequence = (None,),
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
) -> list[torch.Tensor]:
    """The plain PyTorch version of the whole ring in one process, which autograd differentiates.

    Per shift and slab: concatenate the left neighbour's rows, fold and solve
    the padded slab, keep the rows ``[0, L - s1)`` and take the last ``s1``
    from the right neighbour's result; f32 mean over the shifts; cast.
    """
    n = len(slabs)
    sums = [0.0] * n
    for shift in shifts:
        sh = _norm_shift(shift, patch)
        s1 = sh[0]
        halos = [slabs[i - 1][:, slabs[i - 1].shape[1] - s1:] if s1 else None for i in range(n)]
        passes = [windowed_nmf_slab_pass_plain(x, h, u0, v0, head_dim, patch, sh, solver, num_iters, eps, num_grad_steps)
                  for x, h in zip(slabs, halos)]
        for i, (y, _) in enumerate(passes):
            sums[i] = sums[i] + (torch.cat([y, passes[(i + 1) % n][1]], 1) if s1 else y)
    return [(s / len(shifts)).to(x.dtype) for s, x in zip(sums, slabs)]
