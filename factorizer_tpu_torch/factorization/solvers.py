"""Block-coordinate-descent solvers for ``X ≈ U Vᵀ``: the ``cd``, ``hals`` and ``mu`` entries.

PyTorch counterpart of ``CoordinateDescent`` (without a projection as the
``"cd"`` registry entry builds it, with the relu projection as ``"hals"``
builds it) and ``MultiplicativeUpdate`` from
``factorizer_tpu/factorization/solvers.py``.  One call is one BCD iteration:
U first, then V.  Denominators carry ``eps = 1e-16``, which underflows in
bf16, so callers run the solve in at least float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["BCDSolver", "CoordinateDescent", "MultiplicativeUpdate", "SOLVER_DISPATCH_MAP"]

EPS = 1e-16

Factors = tuple[torch.Tensor, torch.Tensor]


def _mT(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


class BCDSolver:
    """One block-coordinate-descent iteration: update U, then V."""

    def __init__(self, eps: float = EPS) -> None:
        self.eps = eps

    def update_u(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def update_v(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        # By symmetry: V solves the transposed problem Xᵀ ≈ V Uᵀ.
        return self.update_u(_mT(x), v, u)

    def __call__(self, x: torch.Tensor, factors: Factors) -> Factors:
        u, v = factors
        u = self.update_u(x, u, v)
        return u, self.update_v(x, u, v)


class CoordinateDescent(BCDSolver):
    """Per-rank coordinate descent; HALS when ``project`` is relu.

    Rank 1 takes the closed form ``project((X v + eps) / (vᵀv + eps))``.
    """

    def __init__(self, eps: float = EPS, project: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> None:
        super().__init__(eps)
        self.project = project if project is not None else (lambda t: t)

    def update_u(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        R = u.shape[-1]
        a, b = x @ v, _mT(v) @ v
        if R == 1:
            return self.project((a + self.eps) / (b + self.eps))
        cols = [u[..., r : r + 1] for r in range(R)]
        for r in range(R):
            others = [j for j in range(R) if j != r]
            u_others = torch.cat([cols[j] for j in others], dim=-1)
            numerator = a[..., r : r + 1] - u_others @ b[..., others, r : r + 1] + self.eps
            cols[r] = self.project(numerator / (b[..., r : r + 1, r : r + 1] + self.eps))
        return torch.cat(cols, dim=-1)


class MultiplicativeUpdate(BCDSolver):
    """Lee-Seung multiplicative update for NMF."""

    def update_u(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        a, b = x @ v, _mT(v) @ v
        return (u * a + self.eps) / (u @ b + self.eps)


SOLVER_DISPATCH_MAP: dict[str, tuple[type, dict]] = {
    "cd": (CoordinateDescent, {}),
    "hals": (CoordinateDescent, {"project": torch.relu}),
    "mu": (MultiplicativeUpdate, {}),
}
