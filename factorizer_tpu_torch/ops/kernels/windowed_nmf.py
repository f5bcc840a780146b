"""K1: shifted-window rank-1 NMF mixing, forward and backward (``csrc/windowed_nmf.cu``, ``csrc/windowed_nmf_bwd.cu``).

Counterpart of ``windowed_nmf_multi`` in
``factorizer_tpu/ops/pallas/windowed_nmf_kernel.py``: the mean over shifts of
``roll(-s, unfold(solve(fold(roll(+s, x)))))`` on a channels-last volume
``(B, S1, S2, S3, C)``, where the fold cuts ``p^3`` windows and ``C/d`` heads
into ``d x p^3`` matrices and the solve runs ``num_iters`` rank-1 HALS or MU
updates from the shared tables ``u0 (d, 1)`` and ``v0 (p^3, 1)``.

:func:`windowed_nmf` launches the forward kernel once per shift for a CUDA
tensor and is differentiable in ``x``: its backward launches the backward
kernel once per shift (:func:`windowed_nmf_backward`), which reruns the solve
inside each block and walks back through the last ``num_grad_steps``
iterations, so only ``x`` is saved between the two.  ``u0`` and ``v0`` get no
gradient.  A CPU tensor takes :func:`windowed_nmf_plain`, which autograd
differentiates; :func:`windowed_nmf_backward_plain` is that gradient by name.
The solve runs in float32 for every input dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import build

__all__ = ["windowed_nmf", "windowed_nmf_plain", "windowed_nmf_backward", "windowed_nmf_backward_plain", "EPS"]

EPS = 1e-16
SOLVERS = ("hals", "mu")


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
    """One launch of ``entry`` per shift; the passes sum into an f32 scratch, the last scales and casts."""
    _check(x, u0, v0, head_dim, patch, solver)
    dtype = build.dtype_code(x.dtype)
    fn = getattr(build.library(), entry)
    stream = build.stream_of(x)
    u0f = u0.detach().reshape(-1).float().contiguous()
    v0f = v0.detach().reshape(-1).float().contiguous()
    out = torch.empty_like(x)
    n = len(shifts)
    acc = torch.empty(x.shape, dtype=torch.float32, device=x.device) if n > 1 else None
    operands = (x.data_ptr(),) if g is None else (x.data_ptr(), g.data_ptr())
    for i, shift in enumerate(shifts):
        status = fn(
            *operands, None if acc is None else acc.data_ptr(), out.data_ptr(),
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


class _WindowedNMF(torch.autograd.Function):
    """The kernels under autograd: forward saves ``x`` alone; ``u0`` and ``v0`` get no gradient."""

    @staticmethod
    def forward(ctx, x, u0, v0, head_dim, patch, shifts, solver, num_iters, eps, num_grad_steps):
        ctx.save_for_backward(x, u0, v0)
        ctx.config = (head_dim, patch, shifts, solver, num_iters, eps, num_grad_steps)
        return _launch("ftt_windowed_nmf_shift", windowed_nmf, x, None, u0, v0, head_dim, patch,
                       shifts, solver, num_iters, eps)

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
    """Shifted-window NMF mixing of ``x (B, S1, S2, S3, C)``; K1 on the card, plain on the CPU.

    ``shifts`` holds ``None``, ints or 3-tuples.  Returns a tensor of ``x``'s
    shape and dtype, differentiable in ``x``.  ``num_grad_steps`` matters only
    to the gradient.
    """
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    if not build.launches_kernel(x):
        return windowed_nmf_plain(x, u0, v0, head_dim, patch, shifts, solver, num_iters, eps, num_grad_steps)
    return _WindowedNMF.apply(x, u0, v0, head_dim, patch, tuple(shifts), solver, num_iters, eps, num_grad_steps)


windowed_nmf.launches = 0
