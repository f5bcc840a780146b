"""K4: NMF of a flat batch of small matrices, forward and backward (``csrc/nmf.cu``, ``csrc/nmf_bwd.cu``).

Counterpart of ``nmf_reconstruct`` in ``factorizer_tpu/ops/pallas/nmf_kernel.py``:
for every matrix of ``x (..., M, N)``, ``num_iters`` HALS or MU iterations of
rank 1 to 4 from the shared tables ``u0 (M, R)`` and ``v0 (N, R)``, then
``u v^T`` in ``x``'s dtype.  It carries every Factorizer mixer that K1 does not
take: 2-D models, rank above 1, non-cubic patches and
``factorize_options={"use_windowed": False}``.

:func:`nmf_reconstruct` launches the forward kernel for a CUDA tensor and is
differentiable in ``x``; only ``x`` is saved.  Its backward
(:func:`nmf_reconstruct_backward`) is a kernel at rank 1, where a block reruns
its solve and walks back through the last ``num_grad_steps`` iterations.  At
rank 2 to 4 the backward reruns the solve in torch operations
(:func:`nmf_reconstruct_plain`) on the card and lets autograd differentiate
it, exactly as the JAX package's ``_bwd`` does with XLA; each such call is
counted in ``nmf_reconstruct_backward.recomputes``.  ``u0`` and ``v0`` get no
gradient.  A CPU tensor takes the plain versions.  The solve runs in float32
for every input dtype; a float64 input (CPU only) is solved in float64.  On
the card the kernels read float32 or bfloat16; any other dtype raises.

:func:`supports` says which sizes the forward kernel takes: the matrix and its
factors must fit the 227 KB of shared memory a block may use.
:func:`supports_backward` says the same of the rank-1 backward kernel, which
keeps more on chip and so takes fewer sizes.  A CUDA tensor outside either
raises there; callers route by the two rules, by configuration and shape.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...factorization.solvers import EPS, SOLVER_DISPATCH_MAP
from . import build

__all__ = ["nmf_reconstruct", "nmf_reconstruct_plain", "nmf_reconstruct_backward", "nmf_reconstruct_backward_plain",
           "supports", "supports_backward", "EPS"]

SOLVERS = ("hals", "mu")
MAX_RANK = 4
_SMEM_BYTES = 227 * 1024
_BWD_MAX_ROWS = 256  # the backward's column sums give each of the M rows of x a thread of the block


def _forward_smem_bytes(m: int, n: int, rank: int) -> int:
    """Shared memory of one forward block, as ``csrc/nmf.cu::smem_floats`` counts it."""
    threads = min(-(-n // 32) * 32, 256)
    chunks = max(threads // m, 1)
    return 4 * (n * (m | 1) + (n + m) * rank + chunks * m * rank + 9 * rank * rank)


def _backward_smem_bytes(m: int, n: int, num_iters: int) -> int:
    """Shared memory of one rank-1 backward block, as ``csrc/rank1_nmf_bwd.cuh::rank1_bwd_smem_floats`` counts it."""
    threads = 64 if m <= 64 and n <= 64 else 256
    return 4 * (2 * n * (m + 1) + (num_iters + 1) * (n + m) + num_iters * (m + 1) + 2 * n + 3 * m + threads + 33)


def supports(solver: str, rank: int, size: Sequence[int], num_iters: int = 5) -> bool:
    """Whether the forward kernel covers ``(M, N)`` matrices at this solver and rank: ``hals`` or ``mu``, rank 1
    to 4, the matrix and its factors within one block's shared memory."""
    m, n = size
    if solver not in SOLVERS or not 1 <= rank <= MAX_RANK or m < 1 or n < 1 or num_iters < 1:
        return False
    return _forward_smem_bytes(m, n, rank) <= _SMEM_BYTES


def supports_backward(solver: str, rank: int, size: Sequence[int], num_iters: int = 5) -> bool:
    """Whether a gradient can be had on the card for what :func:`supports` covers.

    At rank 1 the backward kernel must fit: it keeps x, g and every iterate on
    chip and gives each of the M rows a thread, so it takes fewer sizes than
    the forward.  At rank 2 to 4 the backward is the recompute in torch
    operations, which takes any size.
    """
    m, n = size
    if not supports(solver, rank, size, num_iters):
        return False
    return rank > 1 or (m <= _BWD_MAX_ROWS and _backward_smem_bytes(m, n, num_iters) <= _SMEM_BYTES)


def nmf_reconstruct_plain(
    x: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version: the package's solver (``factorization.solvers``) iterated from the shared
    tables, a chain of matrix products, in f32 (f64 for an f64 input).

    The first ``num_iters - num_grad_steps`` iterations see ``x.detach()``, so
    autograd through this function gives the truncated gradient.
    """
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    cls, kwargs = SOLVER_DISPATCH_MAP[solver]
    step = cls(eps=eps, **kwargs)  # one iteration: u from (x, v), then v from (x^T, u)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    num_grad = num_iters if num_grad_steps is None else num_grad_steps
    k = num_iters - num_grad  # leading iterations outside autograd
    x_ng = xf.detach()
    batch = xf.shape[:-2]
    u = u0.detach().to(xf.dtype).expand(*batch, *u0.shape)
    v = v0.detach().to(xf.dtype).expand(*batch, *v0.shape)
    for it in range(1, num_iters + 1):
        u, v = step(x_ng if it <= k else xf, (u, v))
    return (u @ v.transpose(-1, -2)).to(x.dtype)


def nmf_reconstruct_backward_plain(
    x: torch.Tensor,
    g: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
) -> torch.Tensor:
    """``dx`` for the cotangent ``g`` of the output: autograd through :func:`nmf_reconstruct_plain`."""
    if num_grad_steps is not None and num_grad_steps <= 0:
        return torch.zeros_like(x)  # every iteration sees a detached x
    with torch.enable_grad():
        xd = x.detach().requires_grad_(True)
        y = nmf_reconstruct_plain(xd, u0, v0, solver, num_iters, eps, num_grad_steps)
        (dx,) = torch.autograd.grad(y, xd, g)
    return dx


def _check(x, u0, v0, solver: str, num_iters: int) -> tuple[int, int, int, int]:
    """Raise on what the kernels do not take; returns ``(n_mats, M, N, rank)``."""
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    if x.ndim < 2 or u0.ndim != 2 or v0.ndim != 2:
        raise ValueError(f"expected x (..., M, N), u0 (M, R), v0 (N, R); got {tuple(x.shape)}, {tuple(u0.shape)}, {tuple(v0.shape)}")
    m, n = x.shape[-2:]
    rank = u0.shape[1]
    if tuple(u0.shape) != (m, rank) or tuple(v0.shape) != (n, rank):
        raise ValueError(f"tables of shapes ({m}, R) and ({n}, R) expected, got {tuple(u0.shape)} and {tuple(v0.shape)}")
    if not supports(solver, rank, (m, n), num_iters):
        raise ValueError(f"the kernels do not cover solver {solver!r}, rank {rank}, {num_iters} iterations on {m} x {n} "
                         f"matrices (rank 1 to {MAX_RANK}; the matrix and its factors within {_SMEM_BYTES} bytes of shared memory)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if u0.device != x.device or v0.device != x.device:
        raise ValueError("u0 and v0 must lie on x's device")
    return x.numel() // (m * n), m, n, rank


def _tables(u0, v0) -> tuple[torch.Tensor, torch.Tensor]:
    return u0.detach().float().contiguous(), v0.detach().float().contiguous()


def _launch_forward(x, u0, v0, solver: str, num_iters: int, eps: float) -> torch.Tensor:
    n_mats, m, n, rank = _check(x, u0, v0, solver, num_iters)
    dtype = build.dtype_code(x.dtype)
    u0f, v0f = _tables(u0, v0)
    y = torch.empty_like(x)
    status = build.library().ftt_nmf_reconstruct(
        x.data_ptr(), y.data_ptr(), u0f.data_ptr(), v0f.data_ptr(), dtype, n_mats, m, n, rank,
        int(solver == "mu"), num_iters, eps, build.stream_of(x),
    )
    build.check(status, "ftt_nmf_reconstruct")
    nmf_reconstruct.launches += 1
    return y


def nmf_reconstruct_backward(
    x: torch.Tensor,
    g: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
) -> torch.Tensor:
    """``dx`` of :func:`nmf_reconstruct` for the cotangent ``g``.

    On the card: the backward kernel at rank 1 (counted in ``.launches``); at
    rank 2 to 4 a recompute of the solve in torch operations that autograd
    differentiates, as the JAX package's backward does (counted in
    ``.recomputes``).  On the CPU: the plain version.  ``g`` has ``x``'s shape
    and dtype.  Only the last ``num_grad_steps`` iterations are differentiated
    (None = all; 0 gives exactly zero).  A rank-1 size outside
    :func:`supports_backward` raises on the card.
    """
    if not build.launches_kernel(x):
        return nmf_reconstruct_backward_plain(x, g, u0, v0, solver, num_iters, eps, num_grad_steps)
    n_mats, m, n, rank = _check(x, u0, v0, solver, num_iters)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
        raise ValueError("g must be a contiguous tensor of x's shape, dtype and device")
    dtype = build.dtype_code(x.dtype)
    grad_steps = num_iters if num_grad_steps is None else max(min(num_grad_steps, num_iters), 0)
    if grad_steps == 0 or n_mats == 0:
        return torch.zeros_like(x)
    if not supports_backward(solver, rank, (m, n), num_iters):
        raise ValueError(f"the rank-1 backward kernel does not cover {m} x {n} matrices at {num_iters} iterations (at most "
                         f"{_BWD_MAX_ROWS} rows; x, g and every iterate within {_SMEM_BYTES} bytes of shared memory)")
    if rank > 1:
        nmf_reconstruct_backward.recomputes += 1
        return nmf_reconstruct_backward_plain(x, g, u0, v0, solver, num_iters, eps, grad_steps)
    u0f, v0f = _tables(u0, v0)
    dx = torch.empty_like(x)
    status = build.library().ftt_nmf_reconstruct_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), u0f.data_ptr(), v0f.data_ptr(), dtype, n_mats, m, n,
        int(solver == "mu"), num_iters, grad_steps, eps, build.stream_of(x),
    )
    build.check(status, "ftt_nmf_reconstruct_bwd")
    nmf_reconstruct_backward.launches += 1
    return dx


nmf_reconstruct_backward.launches = 0
nmf_reconstruct_backward.recomputes = 0


class _NMFReconstruct(torch.autograd.Function):
    """The kernels under autograd: forward saves ``x`` alone; ``u0`` and ``v0`` get no gradient."""

    @staticmethod
    def forward(ctx, x, u0, v0, solver, num_iters, eps, num_grad_steps):
        ctx.save_for_backward(x, u0, v0)
        ctx.config = (solver, num_iters, eps, num_grad_steps)
        return _launch_forward(x, u0, v0, solver, num_iters, eps)

    @staticmethod
    def backward(ctx, g):
        x, u0, v0 = ctx.saved_tensors
        dx = nmf_reconstruct_backward(x, g.contiguous(), u0, v0, *ctx.config) if ctx.needs_input_grad[0] else None
        return (dx,) + (None,) * 6


def nmf_reconstruct(
    x: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
) -> torch.Tensor:
    """``u v^T`` after ``num_iters`` NMF iterations on every matrix of ``x (..., M, N)``; K4 on the card, plain on the CPU.

    ``u0 (M, R)`` and ``v0 (N, R)`` are the shared initial factors, ``R`` from 1
    to 4 on the card.  Returns a tensor of ``x``'s shape and dtype,
    differentiable in ``x``; ``num_grad_steps`` matters only to the gradient.
    An empty batch comes back as it is.
    """
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    if not build.launches_kernel(x):
        return nmf_reconstruct_plain(x, u0, v0, solver, num_iters, eps, num_grad_steps)
    if x.numel() == 0:
        return x
    return _NMFReconstruct.apply(x, u0, v0, solver, num_iters, eps, num_grad_steps)


nmf_reconstruct.launches = 0
