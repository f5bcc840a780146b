"""K4: NMF of a flat batch of small matrices, forward and backward (``csrc/nmf.cu``, ``csrc/nmf_bwd.cu``).

Counterpart of ``nmf_reconstruct`` in ``factorizer_tpu/ops/pallas/nmf_kernel.py``:
for every matrix of ``x (..., M, N)``, ``num_iters`` HALS or MU iterations of
rank 1 to 4 from the shared tables ``u0 (M, R)`` and ``v0 (N, R)``, then
``u v^T`` in ``x``'s dtype.  It carries every Factorizer mixer that K1 does not
take: 2-D models, rank above 1, non-cubic patches and
``factorize_options={"use_windowed": False}``.

:func:`nmf_reconstruct` launches the forward kernel for a CUDA tensor and is
differentiable in ``x``; only ``x`` is saved.  Each wrapper counts its
launches in ``.launches`` and, by route, in ``.registers_launches`` and
``.shared_launches``.  Its backward
(:func:`nmf_reconstruct_backward`) is a kernel at rank 1, where a block reruns
its solve and walks back through the last ``num_grad_steps`` iterations.  At
rank 2 to 4 the backward reruns the solve in torch operations
(:func:`nmf_reconstruct_plain`) on the card and lets autograd differentiate
it, exactly as the JAX package's ``_bwd`` does with XLA; each such call is
counted in ``nmf_reconstruct_backward.recomputes``.  ``u0`` and ``v0`` get no
gradient.  A CPU tensor takes the plain versions.  The solve runs in float32
for every input dtype; a float64 input (CPU only) is solved in float64.  On
the card the kernels read float32, bfloat16 or float16; any other dtype raises.

:func:`nmf_plan` says how a call runs, as ``csrc/nmf_plan.cuh`` decides it:
the register route at the bundles' sizes, ``M = 8`` and ``N = 512`` or ``64``
(a thread group holds a matrix in registers: forward at ranks 1 to 4, backward
at rank 1), the shared-memory route for any other size whose matrix and
factors fit the 227 KB a block may use.  :func:`supports` and
:func:`supports_backward` are the plan's verdicts; the rank-1 backward keeps
more on chip and so takes fewer sizes.  A CUDA tensor outside either raises
there; callers route by the two rules, by configuration and shape.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import torch

from ...factorization.solvers import EPS, parse_solver
from ...utils.helpers import partialize
from . import build

__all__ = ["nmf_reconstruct", "nmf_reconstruct_plain", "nmf_reconstruct_backward", "nmf_reconstruct_backward_plain",
           "supports", "supports_backward", "nmf_plan", "NmfPlan", "EPS"]

SOLVERS = ("hals", "mu")
ROUTES = ("registers", "shared")  # nmf_plan.cuh's kNmfRegisters, kNmfShared
# The constants of csrc/nmf_plan.cuh that the plan mirrors.
MAX_RANK = 4
_SMEM_BYTES = 227 * 1024  # shared memory a block may use
_MAX_THREADS = 256  # the shared-memory forward's largest block
_BWD_MAX_ROWS = 256  # the shared-memory backward's column sums give each of the M rows of x a thread of the block
_GROUP_BLOCK = 128  # threads of a register-route block
# What one SM of an H100 holds: shared memory, threads, blocks, registers; and an H100's SMs (for `waves`).
_SM_SMEM, _SM_THREADS, _SM_BLOCKS, _SM_REGS = 233472, 2048, 32, 65536
_SMS = 132


def group_min_blocks(rank: int, backward: bool, n: int) -> int:
    """The register kernels' ``__launch_bounds__`` blocks (``ftt::nmf_group_min_blocks``): the blocks an SM holds at
    the registers ptxas takes for each kernel without a bound."""
    if backward:
        return 4 if n == 512 else 5
    return (5, 4, 3, 2)[rank - 1] if n == 512 else (9, 6, 5, 4)[rank - 1]


# The shared-memory kernels' ``__launch_bounds__`` blocks (``ftt::kNmfSharedMinBlocks``): a bound on threads alone,
# so their resident blocks count low.
_SHARED_MIN_BLOCKS = 1


def _group_sum_stride(rank: int) -> int:
    """Floats a warp writes in one group sum: 9 at rank 1 (``group_sum9``), else ``8 R + R (R + 1) / 2`` rounded
    up to a 16-byte vector (``ftt::nmf_group_sum_stride``)."""
    return 9 if rank == 1 else -(-(8 * rank + rank * (rank + 1) // 2) // 4) * 4


def _forward_smem_bytes(m: int, n: int, rank: int, threads: int) -> int:
    """Shared memory of one shared-memory forward block, as ``ftt::nmf_shared_fwd_floats`` counts it."""
    chunks = max(threads // m, 1)
    return 4 * (n * (m | 1) + (n + m) * rank + chunks * m * rank + 9 * rank * rank)


def _backward_smem_bytes(m: int, n: int, num_iters: int, threads: int) -> int:
    """Shared memory of one shared-memory rank-1 backward block, as ``ftt::rank1_bwd_smem_floats`` counts it."""
    return 4 * (2 * n * (m + 1) + (num_iters + 1) * (n + m) + num_iters * (m + 1) + 2 * n + 3 * m + threads + 33)


def _group_bwd_smem_floats(n: int, m: int, num_iters: int, warps: int) -> int:
    """Shared memory floats of one thread group of the register backward (``ftt::rank1_group_bwd_smem_floats``)."""
    return (num_iters + 1) * (n + m) + num_iters * (m + 1) + 2 * 9 * warps


def _resident(threads: int, smem: int, bound_threads: int, min_blocks: int) -> int:
    """Blocks that one SM holds (``ftt::nmf_resident``), at the registers a thread that
    ``__launch_bounds__(bound_threads, min_blocks)`` allows (where ptxas takes fewer, this counts low)."""
    regs = min(255, _SM_REGS // (bound_threads * min_blocks))
    return min(_SM_BLOCKS, _SM_THREADS // threads, _SM_REGS // (regs * threads), _SM_SMEM // (smem + 1024))


class NmfPlan(NamedTuple):
    """How one K4 call runs (``ftt::NmfPlan``): the route, the threads that hold one matrix, the matrices and
    threads of a block, its shared memory in bytes, the blocks one SM holds, the grid, the kernel's
    ``__launch_bounds__`` blocks, and the waves of blocks on the 132 SMs of an H100."""

    route: str
    group_threads: int
    per_block: int
    threads: int
    smem: int
    resident: int
    blocks: int
    min_blocks: int
    waves: float

    def query(self) -> tuple[int, ...]:
        """The fields as ``ftt_nmf_plan_query`` returns them."""
        return (ROUTES.index(self.route), self.group_threads, self.per_block, self.threads, self.smem, self.resident,
                self.blocks, self.min_blocks)

    def describe(self) -> str:
        return (f"{self.route} route, {self.group_threads} threads a matrix, {self.per_block} a block of {self.threads}, "
                f"{self.blocks} blocks, {self.waves:.2f} waves, {self.smem / 1024:.1f} KB")


def nmf_plan(solver: str, rank: int, size: Sequence[int], dtype: torch.dtype = torch.float32, num_iters: int = 5,
             n_mats: int = 1, backward: bool = False, route: Optional[str] = None) -> Optional[NmfPlan]:
    """The launch plan of a K4 call on ``n_mats`` matrices of ``size = (M, N)``: the forward (``backward=False``)
    or the rank-1 backward, as ``csrc/nmf_plan.cuh::nmf_plan`` chooses it; None where no kernel takes the call.

    ``(8, 512)`` and ``(8, 64)`` take the register route (forward at ranks 1 to 4, backward at rank 1) unless the
    backward's iterates overflow a block's shared memory; any other size takes the shared-memory route if its
    matrix and factors fit; the kernels read float32, bfloat16 and float16, and the plan is the same for the two element
    sizes.
    ``route="shared"`` asks for the shared-memory route at a size the register route takes, for a comparison of
    the routes on one size; the wrappers' callers never pass it.  Plans are cached, so a launch pays for a
    dictionary lookup."""
    m, n = (int(v) for v in size)
    return _nmf_plan(solver, int(rank), (m, n), dtype, int(num_iters), int(n_mats), bool(backward), route)


@functools.lru_cache(maxsize=None)
def _nmf_plan(solver: str, rank: int, size: tuple[int, int], dtype: torch.dtype, num_iters: int, n_mats: int,
              backward: bool, route: Optional[str]) -> Optional[NmfPlan]:
    m, n = size
    if (solver not in SOLVERS or not 1 <= rank <= (1 if backward else MAX_RANK) or m < 1 or n < 1 or num_iters < 1
            or n_mats < 1 or dtype not in (torch.float32, torch.bfloat16, torch.float16) or route not in (None, "shared")
            or (route == "shared" and not (m == 8 and n in (512, 64)))):
        return None

    def make(route, group_threads, threads, smem, bound, min_blocks):
        per_block = threads // group_threads
        resident = _resident(threads, smem, bound, min_blocks)
        blocks = -(-n_mats // per_block)
        return NmfPlan(route, group_threads, per_block, threads, smem, resident, blocks, min_blocks,
                       blocks / (_SMS * resident))

    if route is None and m == 8 and n in (512, 64):
        group_threads = 128 if n == 512 else 32
        per_block, warps = _GROUP_BLOCK // group_threads, group_threads // 32
        floats = _group_bwd_smem_floats(n, m, num_iters, warps) if backward else 2 * warps * _group_sum_stride(rank)
        if 4 * floats * per_block <= _SMEM_BYTES:
            return make("registers", group_threads, _GROUP_BLOCK, 4 * floats * per_block, _GROUP_BLOCK,
                        group_min_blocks(rank, backward, n))
    if backward:
        if m > _BWD_MAX_ROWS:
            return None
        threads = 64 if m <= 64 and n <= 64 else 256
        smem, bound = _backward_smem_bytes(m, n, num_iters, threads), threads
    else:
        threads = min(-(-n // 32) * 32, _MAX_THREADS)
        smem, bound = _forward_smem_bytes(m, n, rank, threads), _MAX_THREADS
    if smem > _SMEM_BYTES:
        return None
    return make("shared", threads, threads, smem, bound, _SHARED_MIN_BLOCKS)


def supports(solver: str, rank: int, size: Sequence[int], num_iters: int = 5) -> bool:
    """Whether the forward kernels cover ``(M, N)`` matrices at this solver and rank: ``hals`` or ``mu``, rank 1
    to 4, and a plan (:func:`nmf_plan`): the register route at ``(8, 512)`` and ``(8, 64)``, else the matrix and
    its factors within one block's shared memory."""
    return nmf_plan(solver, rank, size, num_iters=num_iters) is not None


def supports_backward(solver: str, rank: int, size: Sequence[int], num_iters: int = 5) -> bool:
    """Whether a gradient can be had on the card for what :func:`supports` covers.

    At rank 1 the backward kernel must have a plan: it keeps x, g and every
    iterate on chip and, on the shared-memory route, gives each of the M rows
    a thread, so it takes fewer sizes than the forward.  At rank 2 to 4 the
    backward is the recompute in torch operations, which takes any size.
    """
    if not supports(solver, rank, size, num_iters):
        return False
    return rank > 1 or nmf_plan(solver, 1, size, num_iters=num_iters, backward=True) is not None


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
    step = partialize(parse_solver(solver))(eps=eps)  # one iteration: u from (x, v), then v from (x^T, u)
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
                         f"matrices (rank 1 to {MAX_RANK}; (8, 512) or (8, 64) in registers, else the matrix and its "
                         f"factors within {_SMEM_BYTES} bytes of shared memory)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if u0.device != x.device or v0.device != x.device:
        raise ValueError("u0 and v0 must lie on x's device")
    return x.numel() // (m * n), m, n, rank


def _tables(u0, v0) -> tuple[torch.Tensor, torch.Tensor]:
    return u0.detach().float().contiguous(), v0.detach().float().contiguous()


def _route_code(route: Optional[str]) -> int:
    return -1 if route is None else ROUTES.index(route)


def _route(solver: str, rank: int, size: tuple[int, int], dtype: torch.dtype, num_iters: int, n_mats: int,
           backward: bool, route: Optional[str]) -> str:
    """The route a launch takes (the C entry plans it again, the same way), for the launch counters."""
    plan = _nmf_plan(solver, rank, size, dtype, num_iters, n_mats, backward, route)
    if plan is None:
        raise ValueError(f"no K4 kernel takes {n_mats} matrices of {size} at rank {rank}"
                         + (f" on the {route} route" if route else ""))
    return plan.route


def _count(wrapper, route: str) -> None:
    """One launch of the kernel of ``route`` behind ``wrapper``: its own count and the wrapper's."""
    wrapper.launches += 1
    setattr(wrapper, f"{route}_launches", getattr(wrapper, f"{route}_launches") + 1)


def _launch_forward(x, u0, v0, solver: str, num_iters: int, eps: float, route: Optional[str] = None) -> torch.Tensor:
    """The forward kernel on a CUDA tensor, by the plan's route or ``route`` ("shared")."""
    n_mats, m, n, rank = _check(x, u0, v0, solver, num_iters)
    dtype = build.dtype_code(x.dtype)
    taken = _route(solver, rank, (m, n), x.dtype, num_iters, n_mats, False, route)
    u0f, v0f = _tables(u0, v0)
    y = torch.empty_like(x)
    status = build.library().ftt_nmf_reconstruct(
        x.data_ptr(), y.data_ptr(), u0f.data_ptr(), v0f.data_ptr(), dtype, n_mats, m, n, rank,
        int(solver == "mu"), num_iters, eps, _route_code(route), build.stream_of(x),
    )
    build.check(status, "ftt_nmf_reconstruct")
    _count(nmf_reconstruct, taken)
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
    build.dtype_code(x.dtype)  # raises on a dtype the kernels do not read
    grad_steps = num_iters if num_grad_steps is None else max(min(num_grad_steps, num_iters), 0)
    if grad_steps == 0 or n_mats == 0:
        return torch.zeros_like(x)
    if not supports_backward(solver, rank, (m, n), num_iters):
        raise ValueError(f"the rank-1 backward kernel does not cover {m} x {n} matrices at {num_iters} iterations (at most "
                         f"{_BWD_MAX_ROWS} rows; x, g and every iterate within {_SMEM_BYTES} bytes of shared memory)")
    if rank > 1:
        nmf_reconstruct_backward.recomputes += 1
        return nmf_reconstruct_backward_plain(x, g, u0, v0, solver, num_iters, eps, grad_steps)
    return _launch_backward(x, g, u0, v0, solver, num_iters, grad_steps, eps)


def _launch_backward(x, g, u0, v0, solver: str, num_iters: int, grad_steps: int, eps: float,
                     route: Optional[str] = None) -> torch.Tensor:
    """The rank-1 backward kernel on CUDA tensors, by the plan's route or ``route`` ("shared")."""
    n_mats, m, n, _ = _check(x, u0, v0, solver, num_iters)
    taken = _route(solver, 1, (m, n), x.dtype, num_iters, n_mats, True, route)
    u0f, v0f = _tables(u0, v0)
    dx = torch.empty_like(x)
    status = build.library().ftt_nmf_reconstruct_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), u0f.data_ptr(), v0f.data_ptr(), build.dtype_code(x.dtype), n_mats,
        m, n, int(solver == "mu"), num_iters, grad_steps, eps, _route_code(route), build.stream_of(x),
    )
    build.check(status, "ftt_nmf_reconstruct_bwd")
    _count(nmf_reconstruct_backward, taken)
    return dx


# Launches of the backward kernels, all routes and by route; rank 2 to 4 recomputes in torch operations.
nmf_reconstruct_backward.launches = 0
nmf_reconstruct_backward.registers_launches = 0
nmf_reconstruct_backward.shared_launches = 0
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
    if torch.is_grad_enabled() and x.requires_grad:
        return _NMFReconstruct.apply(x, u0, v0, solver, num_iters, eps, num_grad_steps)
    return _launch_forward(x, u0, v0, solver, num_iters, eps)  # no graph to record: the launch without the autograd function's cost


# Launches of the forward kernels, all routes and by route.
nmf_reconstruct.launches = 0
nmf_reconstruct.registers_launches = 0
nmf_reconstruct.shared_launches = 0
