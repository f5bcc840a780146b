"""Differentiable matrix-factorization layers (MF / NMF).

PyTorch counterpart of ``factorizer_tpu/factorization/nmf.py``.  The first
``num_iters - num_grad_steps`` iterations consume ``x.detach()``, so the
factors entering the differentiable tail are constants for autograd, as the
JAX package's ``stop_gradient`` phase makes them.  bf16 and f16 inputs are
solved in float32 and the reconstruction is cast back.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

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
        solver: ``"hals"`` or ``"mu"``; its divides carry ``eps = 1e-16``.
        num_iters: number of BCD iterations.
        num_grad_steps: trailing iterations that are differentiable (None = all).
    """

    def __init__(
        self,
        size: Sequence[int],
        rank: Optional[int] = None,
        init_method: str = "normal",
        solver: str = "hals",
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in (torch.bfloat16, torch.float16):
            u, v = self.decompose(x.float())
            return self.reconstruct(u, v).to(x.dtype)
        return self.reconstruct(*self.decompose(x))


class NMF(MatrixFactorization):
    """Nonnegative ``X ≈ U Vᵀ``: uniform init and HALS by default."""

    def __init__(self, size: Sequence[int], init_method: str = "uniform", solver: str = "hals", **kwargs) -> None:
        super().__init__(size, init_method=init_method, solver=solver, **kwargs)
