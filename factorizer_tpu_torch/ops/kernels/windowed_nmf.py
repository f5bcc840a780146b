"""K1: shifted-window rank-1 NMF mixing, forward and backward (``csrc/windowed_nmf.cu``, ``csrc/windowed_nmf_bwd.cu``).

Counterpart of ``windowed_nmf_multi`` in
``factorizer_tpu/ops/pallas/windowed_nmf_kernel.py``: the mean over shifts of
``roll(-s, unfold(solve(fold(roll(+s, x)))))`` on a channels-last volume
``(B, S1, S2, S3, C)``, where the fold cuts ``p^3`` windows and ``C/d`` heads
into ``d x p^3`` matrices and the solve runs ``num_iters`` rank-1 HALS or MU
updates from the shared tables ``u0 (d, 1)`` and ``v0 (p^3, 1)``.

:func:`windowed_nmf` runs the forward in two passes for a CUDA tensor:
:func:`windowed_nmf_factors` (one launch over all shifts) solves every matrix
and keeps only its factors, ``U (n, B, G, C/d, d)`` and ``V (n, B, G, C/d, p^3)``
in f32 (``G`` windows); :func:`windowed_nmf_reconstruct` (one launch) writes
each output element once as the mean over shifts of the factors' product.
The plain counterparts :func:`windowed_nmf_factors_plain` and
:func:`windowed_nmf_reconstruct_plain` compose to :func:`windowed_nmf_plain`.
:func:`windowed_nmf` is differentiable in ``x``: its backward launches the
backward kernel once per shift (:func:`windowed_nmf_backward`), which reruns
the solve inside each block and walks back through the last
``num_grad_steps`` iterations, so only ``x`` is saved between the two.
``u0`` and ``v0`` get no gradient.  A CPU tensor takes the plain versions,
which autograd differentiates; :func:`windowed_nmf_backward_plain` is that
gradient by name.  The solve runs in float32 for every input dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch

from . import build

__all__ = [
    "windowed_nmf", "windowed_nmf_plain", "windowed_nmf_backward", "windowed_nmf_backward_plain",
    "windowed_nmf_factors", "windowed_nmf_factors_plain", "windowed_nmf_reconstruct", "windowed_nmf_reconstruct_plain",
    "factor_shapes", "EPS",
]

EPS = 1e-16
SOLVERS = ("hals", "mu")
# Most shifts one forward launch takes (``kMaxShifts`` in csrc/windowed_nmf.cuh): a call with more launches each
# pass once per group of them, and the reconstruct pass carries its sum between groups in an f32 volume.
MAX_SHIFTS = 8


def _norm_shift(shift, patch: int) -> tuple[int, int, int]:
    """``None`` / int / 3-tuple -> a 3-tuple in ``[0, patch)``.

    Rolling by a multiple of the patch only renumbers whole windows, so the
    shift is taken modulo ``patch``.
    """
    if shift is None:
        return (0, 0, 0)
    if isinstance(shift, int):
        shift = (shift, shift, shift)
    s = tuple(int(v) % patch for v in shift)
    if len(s) != 3:
        raise ValueError(f"shift must be a 3-tuple, got {shift!r}")
    return s


def _fold(x: torch.Tensor, d: int, p: int) -> torch.Tensor:
    """Channels-last volume -> ``(B*h, G, d, p^3)`` (the Matricize equation)."""
    B, s1, s2, s3, c = x.shape
    h = c // d
    x = x.reshape(B, s1 // p, p, s2 // p, p, s3 // p, p, h, d)
    x = x.permute(0, 7, 1, 3, 5, 8, 2, 4, 6)  # B h g1 g2 g3 d p p p
    return x.reshape(B * h, -1, d, p**3)


def _unfold(y: torch.Tensor, shape: Sequence[int], d: int, p: int) -> torch.Tensor:
    B, s1, s2, s3, c = shape
    y = y.reshape(B, c // d, s1 // p, s2 // p, s3 // p, d, p, p, p)
    y = y.permute(0, 2, 6, 3, 7, 4, 8, 1, 5)
    return y.reshape(tuple(shape))


def _rank1_solve(m, u0, v0, solver: str, num_iters: int, eps: float, num_grad_steps: Optional[int]):
    """``num_iters`` rank-1 updates on matrices ``m (..., d, N)``, U first then V."""
    num_grad = num_iters if num_grad_steps is None else num_grad_steps
    k = num_iters - num_grad  # leading iterations outside autograd
    m_ng = m.detach()
    u = u0.to(m.dtype).expand(*m.shape[:-2], *u0.shape)
    v = v0.to(m.dtype).expand(*m.shape[:-2], *v0.shape)
    for it in range(1, num_iters + 1):
        x = m_ng if it <= k else m
        a, b = x @ v, v.transpose(-1, -2) @ v
        u = torch.relu((a + eps) / (b + eps)) if solver == "hals" else (u * a + eps) / (u * b + eps)
        a, b = x.transpose(-1, -2) @ u, u.transpose(-1, -2) @ u
        v = torch.relu((a + eps) / (b + eps)) if solver == "hals" else (v * a + eps) / (v * b + eps)
    return u, v


def windowed_nmf_plain(
    x: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    head_dim: int,
    patch: int,
    shifts: Sequence = (None,),
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version: roll, fold, solve, unfold, un-roll per shift; f32 mean; cast.

    A float64 input is solved in float64, for the semantic checks."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    acc = None
    for shift in shifts:
        sh = _norm_shift(shift, patch)
        xs = torch.roll(xf, sh, (1, 2, 3)) if any(sh) else xf
        u, v = _rank1_solve(_fold(xs, head_dim, patch), u0, v0, solver, num_iters, eps, num_grad_steps)
        ys = _unfold(u @ v.transpose(-1, -2), x.shape, head_dim, patch)
        if any(sh):
            ys = torch.roll(ys, tuple(-s for s in sh), (1, 2, 3))
        acc = ys if acc is None else acc + ys
    return (acc / len(shifts)).to(x.dtype)


def factor_shapes(shape: Sequence[int], head_dim: int, patch: int, n_shifts: int) -> tuple[tuple, tuple]:
    """Shapes of the factors buffer of a volume ``shape``: ``U (n, B, G, C/d, d)`` and ``V (n, B, G, C/d, p^3)``,
    ``G`` the windows in (g1, g2, g3) order."""
    B, s1, s2, s3, c = shape
    lead = (n_shifts, B, (s1 // patch) * (s2 // patch) * (s3 // patch), c // head_dim)
    return (*lead, head_dim), (*lead, patch**3)


def windowed_nmf_factors_plain(
    x: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    head_dim: int,
    patch: int,
    shifts: Sequence = (None,),
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass A, plain: per shift, roll, fold and solve; the factors in :func:`factor_shapes`' layout, in
    float32 (float64 for a float64 input)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    B, c = x.shape[0], x.shape[-1]
    h = c // head_dim
    us, vs = [], []
    for shift in shifts:
        sh = _norm_shift(shift, patch)
        xs = torch.roll(xf, sh, (1, 2, 3)) if any(sh) else xf
        u, v = _rank1_solve(_fold(xs, head_dim, patch), u0, v0, solver, num_iters, eps, num_grad_steps)
        us.append(u.reshape(B, h, -1, head_dim).transpose(1, 2))  # (B*h, G, d, 1) -> (B, G, h, d)
        vs.append(v.reshape(B, h, -1, patch**3).transpose(1, 2))
    return torch.stack(us), torch.stack(vs)


def windowed_nmf_reconstruct_plain(
    U: torch.Tensor, V: torch.Tensor, shape: Sequence[int], dtype: torch.dtype, head_dim: int, patch: int,
    shifts: Sequence = (None,),
) -> torch.Tensor:
    """Pass B, plain: per shift, ``u v^T`` unfolded and un-rolled; the mean over shifts, cast to ``dtype``."""
    B, c = shape[0], shape[-1]
    h = c // head_dim
    acc = None
    for i, shift in enumerate(shifts):
        sh = _norm_shift(shift, patch)
        u = U[i].transpose(1, 2).reshape(B * h, -1, head_dim, 1)
        v = V[i].transpose(1, 2).reshape(B * h, -1, patch**3, 1)
        ys = _unfold(u @ v.transpose(-1, -2), shape, head_dim, patch)
        if any(sh):
            ys = torch.roll(ys, tuple(-s for s in sh), (1, 2, 3))
        acc = ys if acc is None else acc + ys
    return (acc / len(shifts)).to(dtype)


def _shift_table(shifts, patch: int):
    """The normalised shifts as the C entry points take them: ``n x 3`` ints in host memory.  A model calls
    with the same few shift lists over and over, so the table is kept per list of normalised shifts."""
    return _table(tuple(_norm_shift(shift, patch) for shift in shifts), patch)


@functools.lru_cache(maxsize=64)
def _table(shifts: tuple, patch: int):
    if not shifts:
        raise ValueError("the forward kernel takes at least one shift")
    flat = [s for shift in shifts for s in _norm_shift(shift, patch)]
    return (ctypes.c_int * len(flat))(*flat)


def _f32_table(t: torch.Tensor) -> torch.Tensor:
    """``u0`` / ``v0`` as the flat f32 table the kernels read (the tensor itself when it already is one)."""
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.detach().float().contiguous()


def _sum_scratch(shape, n_shifts: int, device) -> Optional[torch.Tensor]:
    """The reconstruct pass's f32 running sum between groups of shifts, where there is more than one group."""
    return torch.empty(tuple(shape), dtype=torch.float32, device=device) if n_shifts > MAX_SHIFTS else None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def windowed_nmf_factors(
    x: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    head_dim: int,
    patch: int,
    shifts: Sequence = (None,),
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass A: the factors of every shift's matrices, ``(U, V)`` in f32; one kernel launch on the card, plain
    on the CPU.  No gradient flows through the kernel's factors (:func:`windowed_nmf` differentiates)."""
    if not build.launches_kernel(x):
        return windowed_nmf_factors_plain(x, u0, v0, head_dim, patch, shifts, solver, num_iters, eps)
    _check(x, u0, v0, head_dim, patch, solver)
    build.check_aligned("x", x)
    table = _shift_table(shifts, patch)
    u_shape, v_shape = factor_shapes(x.shape, head_dim, patch, len(shifts))
    U = torch.empty(u_shape, dtype=torch.float32, device=x.device)
    V = torch.empty(v_shape, dtype=torch.float32, device=x.device)
    status = build.library().ftt_windowed_nmf_factors(
        x.data_ptr(), U.data_ptr(), V.data_ptr(), _f32_table(u0).data_ptr(), _f32_table(v0).data_ptr(),
        build.dtype_code(x.dtype), *x.shape,
        head_dim, patch, len(shifts), table, int(solver == "mu"), num_iters, eps, build.stream_of(x),
    )
    build.check(status, "windowed_nmf_factors")
    windowed_nmf_factors.launches += 1
    return U, V


windowed_nmf_factors.launches = 0


def windowed_nmf_reconstruct(
    U: torch.Tensor, V: torch.Tensor, shape: Sequence[int], dtype: torch.dtype, head_dim: int, patch: int,
    shifts: Sequence = (None,),
) -> torch.Tensor:
    """Pass B: the mean over shifts of the factors' product, a ``shape`` volume of ``dtype``; one kernel launch
    on the card, plain on the CPU."""
    if not build.launches_kernel(U):
        return windowed_nmf_reconstruct_plain(U, V, shape, dtype, head_dim, patch, shifts)
    u_shape, v_shape = factor_shapes(shape, head_dim, patch, len(shifts))
    for name, t, want in (("U", U, u_shape), ("V", V, v_shape)):
        if tuple(t.shape) != want or t.dtype != torch.float32 or not t.is_contiguous() or t.device != U.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor of shape {want} on {U.device}")
    out = torch.empty(tuple(shape), dtype=dtype, device=U.device)
    acc = _sum_scratch(shape, len(shifts), U.device)
    build.check_aligned("U", U)
    status = build.library().ftt_windowed_nmf_reconstruct(
        U.data_ptr(), V.data_ptr(), _ptr(acc), out.data_ptr(),
        build.dtype_code(dtype), *shape, head_dim, patch, len(shifts), _shift_table(shifts, patch), build.stream_of(U),
    )
    build.check(status, "windowed_nmf_reconstruct")
    windowed_nmf_reconstruct.launches += 1
    return out


windowed_nmf_reconstruct.launches = 0


def windowed_nmf_backward_plain(
    x: torch.Tensor,
    g: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    head_dim: int,
    patch: int,
    shifts: Sequence = (None,),
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
) -> torch.Tensor:
    """``dx`` for the cotangent ``g`` of the output: autograd through :func:`windowed_nmf_plain`."""
    if num_grad_steps is not None and num_grad_steps <= 0:
        return torch.zeros_like(x)  # every iteration sees a detached x
    with torch.enable_grad():
        xd = x.detach().requires_grad_(True)
        y = windowed_nmf_plain(xd, u0.detach(), v0.detach(), head_dim, patch, shifts, solver, num_iters, eps, num_grad_steps)
        (dx,) = torch.autograd.grad(y, xd, g)
    return dx


def _check(x, u0, v0, head_dim: int, patch: int, solver: str) -> None:
    """Raise on what the kernels do not take."""
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    if x.ndim != 5:
        raise ValueError(f"expected a (B, S1, S2, S3, C) volume, got shape {tuple(x.shape)}")
    _, s1, s2, s3, c = x.shape
    if c % head_dim or s1 % patch or s2 % patch or s3 % patch:
        raise ValueError(f"shape {tuple(x.shape)} does not split into heads of {head_dim} and patches of {patch}")
    if tuple(u0.shape) != (head_dim, 1) or tuple(v0.shape) != (patch**3, 1):
        raise ValueError(f"rank-1 tables of shapes ({head_dim}, 1) and ({patch**3}, 1) expected")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if u0.device != x.device or v0.device != x.device:
        raise ValueError("u0 and v0 must lie on x's device")


def _launch(entry: str, counter, x, g, u0, v0, head_dim, patch, shifts, solver, num_iters, eps, extra=()):
    """One launch of the backward ``entry`` per shift; the passes sum into an f32 scratch, the last scales and
    casts."""
    _check(x, u0, v0, head_dim, patch, solver)
    dtype = build.dtype_code(x.dtype)
    fn = getattr(build.library(), entry)
    stream = build.stream_of(x)
    u0f = u0.detach().reshape(-1).float().contiguous()
    v0f = v0.detach().reshape(-1).float().contiguous()
    out = torch.empty_like(x)
    n = len(shifts)
    acc = torch.empty(x.shape, dtype=torch.float32, device=x.device) if n > 1 else None
    for name, t in (("x", x), ("g", g)):
        build.check_aligned(name, t)  # the compile-time sizes move rows in 16-byte accesses
    for i, shift in enumerate(shifts):
        status = fn(
            x.data_ptr(), g.data_ptr(), None if acc is None else acc.data_ptr(), out.data_ptr(),
            u0f.data_ptr(), v0f.data_ptr(), dtype, *x.shape, head_dim, patch,
            *_norm_shift(shift, patch), int(solver == "mu"), num_iters, *extra, eps,
            int(i == 0), int(i == n - 1), 1.0 / n, stream,
        )
        build.check(status, entry)
        counter.launches += 1
    return out


def windowed_nmf_backward(
    x: torch.Tensor,
    g: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    head_dim: int,
    patch: int,
    shifts: Sequence = (None,),
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
) -> torch.Tensor:
    """``dx`` of :func:`windowed_nmf` for the cotangent ``g``; the backward kernel on the card, plain on the CPU.

    ``g`` has ``x``'s shape and dtype.  Only the last ``num_grad_steps``
    iterations are differentiated (None = all; 0 gives exactly zero).
    """
    if not build.launches_kernel(x):
        return windowed_nmf_backward_plain(x, g, u0, v0, head_dim, patch, shifts, solver, num_iters, eps, num_grad_steps)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
        raise ValueError("g must be a contiguous tensor of x's shape, dtype and device")
    grad_steps = num_iters if num_grad_steps is None else max(min(num_grad_steps, num_iters), 0)
    if grad_steps == 0:
        return torch.zeros_like(x)
    return _launch("ftt_windowed_nmf_shift_bwd", windowed_nmf_backward, x, g, u0, v0, head_dim, patch,
                   shifts, solver, num_iters, eps, extra=(grad_steps,))


windowed_nmf_backward.launches = 0


def _forward(x, u0, v0, head_dim, patch, shifts, solver, num_iters, eps) -> torch.Tensor:
    """Both forward passes in one call into the library: one launch each, counted on each pass's wrapper."""
    _check(x, u0, v0, head_dim, patch, solver)
    build.check_aligned("x", x)
    u_shape, v_shape = factor_shapes(x.shape, head_dim, patch, len(shifts))
    n_u = math.prod(u_shape)
    factors = torch.empty(n_u + math.prod(v_shape), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    acc = _sum_scratch(x.shape, len(shifts), x.device)
    status = build.library().ftt_windowed_nmf_forward(
        x.data_ptr(), factors.data_ptr(), factors.data_ptr() + 4 * n_u, _ptr(acc), out.data_ptr(),
        _f32_table(u0).data_ptr(), _f32_table(v0).data_ptr(),
        build.dtype_code(x.dtype), *x.shape, head_dim, patch, len(shifts), _shift_table(shifts, patch),
        int(solver == "mu"), num_iters, eps, build.stream_of(x),
    )
    build.check(status, "windowed_nmf_forward")
    windowed_nmf_factors.launches += 1
    windowed_nmf_reconstruct.launches += 1
    return out


class _WindowedNMF(torch.autograd.Function):
    """The kernels under autograd: forward saves ``x`` alone; ``u0`` and ``v0`` get no gradient."""

    @staticmethod
    def forward(ctx, x, u0, v0, head_dim, patch, shifts, solver, num_iters, eps, num_grad_steps):
        ctx.save_for_backward(x, u0, v0)
        ctx.config = (head_dim, patch, shifts, solver, num_iters, eps, num_grad_steps)
        return _forward(x, u0, v0, head_dim, patch, shifts, solver, num_iters, eps)

    @staticmethod
    def backward(ctx, g):
        x, u0, v0 = ctx.saved_tensors
        dx = windowed_nmf_backward(x, g.contiguous(), u0, v0, *ctx.config) if ctx.needs_input_grad[0] else None
        return (dx,) + (None,) * 9


def windowed_nmf(
    x: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    head_dim: int,
    patch: int,
    shifts: Sequence = (None,),
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
) -> torch.Tensor:
    """Shifted-window NMF mixing of ``x (B, S1, S2, S3, C)``; K1's two forward passes on the card, plain on the CPU.

    ``shifts`` holds ``None``, ints or 3-tuples.  Returns a tensor of ``x``'s
    shape and dtype, differentiable in ``x``.  ``num_grad_steps`` matters only
    to the gradient.
    """
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    if not build.launches_kernel(x):
        return windowed_nmf_plain(x, u0, v0, head_dim, patch, shifts, solver, num_iters, eps, num_grad_steps)
    if not (torch.is_grad_enabled() and x.requires_grad):  # no graph to record: the launches alone
        return _forward(x, u0, v0, head_dim, patch, tuple(shifts), solver, num_iters, eps)
    return _WindowedNMF.apply(x, u0, v0, head_dim, patch, tuple(shifts), solver, num_iters, eps, num_grad_steps)
