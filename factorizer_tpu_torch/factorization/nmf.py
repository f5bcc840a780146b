"""Differentiable matrix-factorization layers (MF / NMF).

PyTorch counterpart of ``factorizer_tpu/factorization/nmf.py``.  The first
``num_iters - num_grad_steps`` iterations consume ``x.detach()``, so the
factors entering the differentiable tail are constants for autograd, as the
JAX package's ``stop_gradient`` phase makes them.

``forward`` has two routes, chosen by configuration and shape, never by the
input's dtype or device.  A batch of matrices (``x.ndim >= 3``) under ``hals``
or ``mu`` at rank 1 to 4 whose size the flat kernel takes
(``ops.kernels.nmf.supports``) goes through ``ops.kernels.nmf_reconstruct``:
K4 on the card, which reads f32 or bf16, solves in f32 on chip and raises for
any other dtype, and its plain version on the CPU.  Everything else, the
default global ``Matricize`` (``M = C``, ``N`` = all voxels) among it, takes
the ``decompose`` chain of matrix products; there bf16 and f16 inputs are
solved in float32 and the reconstruction is cast back.  A few rank-1 sizes fit
the forward kernel but not the backward kernel, which keeps more on chip
(``ops.kernels.nmf.supports_backward``): they are served through K4, and take
the ``decompose`` chain only when a gradient with respect to the input is
being recorded.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.kernels import nmf as nmf_kernel
from .inits import RandomInit
from .solvers import EPS, SOLVER_DISPATCH_MAP

__all__ = ["MatrixFactorization", "NMF", "infer_rank"]

def infer_rank(size: Sequence[int], rank: Optional[int], compression: float) -> int:
    """``rank``, or the auto-rank rule ``ceil(M*N / (compression*(M+N)))`` if it is None."""
    if rank is not None:
        return rank
    M, N = size
    return max(math.ceil(M * N / (compression * (M + N))), 1)


class MatrixFactorization(nn.Module):
    """``X ≈ U Vᵀ`` over the trailing two axes; ``forward`` returns ``U Vᵀ``.

    Args:
        size: ``(M, N)`` of the factorized matrices.
        rank: factorization rank; None takes the auto-rank rule at compression 10.
        init_method: ``"uniform"`` or ``"normal"`` (a ``RandomInit``).
        solver: ``"cd"`` (coordinate descent without a projection, the JAX package's default),
            ``"hals"`` (with a relu projection) or ``"mu"``; its divides carry ``eps = 1e-16``.
        num_iters: number of BCD iterations.
        num_grad_steps: trailing iterations that are differentiable (None = all).
    """

    def __init__(
        self,
        size: Sequence[int],
        rank: Optional[int] = None,
        init_method: str = "normal",
        solver: str = "cd",
        num_iters: int = 5,
        num_grad_steps: Optional[int] = None,
        device: Optional[torch.device] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.size = tuple(size)
        self.rank = infer_rank(self.size, rank, 10.0)
        self.solver = solver
        self.num_iters = num_iters
        self.num_grad_steps = num_grad_steps
        self.eps = EPS
        self.init = RandomInit(self.size, self.rank, init_method, device, generator)
        cls, kwargs = SOLVER_DISPATCH_MAP[solver]
        self.solver_ = cls(eps=self.eps, **kwargs)

    def decompose(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``num_iters`` solver iterations on ``x (..., M, N)``: ``u (..., M, R)``, ``v (..., N, R)``."""
        num_grad = self.num_iters if self.num_grad_steps is None else self.num_grad_steps
        k = self.num_iters - num_grad  # leading iterations outside autograd
        x_ng = x.detach()
        u, v = self.init(x_ng)
        for it in range(1, self.num_iters + 1):
            u, v = self.solver_(x_ng if it <= k else x, (u, v))
        return u, v

    def reconstruct(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return u @ v.transpose(-1, -2)

    def supports(self, backward: bool = False) -> bool:
        """Whether the flat kernel covers this configuration (solver, rank, size, iterations), and with
        ``backward`` whether its gradient can be had there too."""
        rule = nmf_kernel.supports_backward if backward else nmf_kernel.supports
        return rule(self.solver, self.rank, self.size, self.num_iters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        differentiated = torch.is_grad_enabled() and x.requires_grad
        if x.ndim >= 3 and self.supports(backward=differentiated):
            return nmf_kernel.nmf_reconstruct(
                x.contiguous(), self.init.u0, self.init.v0, self.solver, self.num_iters, self.eps, self.num_grad_steps
            )
        if x.dtype in (torch.bfloat16, torch.float16):
            u, v = self.decompose(x.float())
            return self.reconstruct(u, v).to(x.dtype)
        return self.reconstruct(*self.decompose(x))


class NMF(MatrixFactorization):
    """Nonnegative ``X ≈ U Vᵀ``: uniform init and HALS by default."""

    def __init__(self, size: Sequence[int], init_method: str = "uniform", solver: str = "hals", **kwargs) -> None:
        super().__init__(size, init_method=init_method, solver=solver, **kwargs)
