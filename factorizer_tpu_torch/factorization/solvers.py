"""Block-coordinate-descent solvers for matrix factorization ``X ≈ U Vᵀ``.

PyTorch counterpart of ``factorizer_tpu/factorization/solvers.py``: every
solver, the 27 registry names of ``SOLVER_DISPATCH_MAP`` and ``parse_solver``.
A solver is a stateless object; one call is one BCD iteration over the factors
in ``factor`` (0 = U, 1 = V), in that order.  Denominators carry
``eps = 1e-16``, which underflows in bf16, so callers solve in at least
float32.  ``LeastSquares`` passes the JAX package's ``pinv`` cut-off
(``10 * max(M, N) * eps`` of the dtype, relative to the largest singular
value) explicitly: ``torch.linalg.pinv``'s own default is ten times smaller.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from ..utils.helpers import as_tuple, is_partializable, partialize

__all__ = [
    "BCDSolver",
    "LeastSquares",
    "ProjectedGradient",
    "CoordinateDescent",
    "MultiplicativeUpdate",
    "FastMultiplicativeUpdate",
    "WeightedMultiplicativeUpdate",
    "SemiMultiplicativeUpdate",
    "Compose",
    "SOLVER_DISPATCH_MAP",
    "parse_solver",
]

EPS = 1e-16

Factors = tuple[torch.Tensor, torch.Tensor]


def _mT(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _resolve_project(project) -> Callable[[torch.Tensor], torch.Tensor]:
    """An elementwise function (``torch.relu``) as it is, a factory (``nn.ReLU``, ``(cls, kwargs)``) called once."""
    if project is None:
        return lambda x: x
    project = partialize(project)
    try:
        if isinstance(project(torch.zeros(())), torch.Tensor):
            return project
    except TypeError:
        pass
    return project()


def _pinv(a: torch.Tensor) -> torch.Tensor:
    """``pinv`` with the JAX package's cut-off: singular values up to ``10 * max(M, N) * eps`` of the largest are dropped."""
    return torch.linalg.pinv(a, rtol=10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps)


class BCDSolver:
    """Base class: one block-coordinate-descent iteration for ``X ≈ U Vᵀ``.

    Args:
        factor: the factors to update, in order; a subset of ``{0, 1}`` (0 = U, 1 = V).
    """

    def __init__(self, factor: int | Sequence[int] = (0, 1), *args: Any, **kwargs: Any) -> None:
        self.factor = as_tuple(factor)
        if not set(self.factor).issubset({0, 1}):
            raise ValueError("`factor` elements must be 0 or 1.")

    def update_u(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def update_v(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        # By symmetry: V solves the transposed problem Xᵀ ≈ V Uᵀ.
        return self.update_u(_mT(x), v, u)

    def __call__(self, x: torch.Tensor, factors: Factors, *args: Any, **kwargs: Any) -> Factors:
        u, v = factors
        for j in self.factor:
            if j == 0:
                u = self.update_u(x, u, v)
            else:
                v = self.update_v(x, u, v)
        return u, v


class LeastSquares(BCDSolver):
    """Exact (optionally projected) least-squares update."""

    def __init__(self, factor: int | Sequence[int] = (0, 1), eps: float = EPS, project=None, **kwargs: Any) -> None:
        super().__init__(factor=factor)
        self.eps = eps
        self.project = _resolve_project(project)

    def update_u(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        M, N = x.shape[-2], x.shape[-1]
        if M >= N:
            u_new = x @ _mT(_pinv(v))
        else:
            a, b = x @ v, _mT(v) @ v
            u_new = _mT(torch.linalg.solve(b, _mT(a)))
        return self.project(u_new)


class ProjectedGradient(BCDSolver):
    """Projected gradient descent with exact line search for the least-squares subproblem."""

    def __init__(self, factor: int | Sequence[int] = (0, 1), project=None, eps: float = EPS, **kwargs: Any) -> None:
        super().__init__(factor=factor)
        self.eps = eps
        self.project = _resolve_project(project)

    def update_u(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        a, b = x @ v, _mT(v) @ v
        g = a - u @ b
        gg = (g * g).sum((-2, -1))[..., None]
        ggb = (g * (g @ b)).sum((-2, -1))[..., None]
        eta = ((gg + self.eps) / (ggb + self.eps))[..., None]
        return self.project(u + eta * g)


class CoordinateDescent(BCDSolver):
    """Per-rank block coordinate descent; HALS when ``project`` is relu.

    The rank loop is sequential (column ``r`` sees the columns already
    updated); rank 1 takes the closed form ``project((X v + eps) / (vᵀv + eps))``.
    """

    def __init__(self, factor: int | Sequence[int] = (0, 1), eps: float = EPS, project=None, **kwargs: Any) -> None:
        super().__init__(factor=factor)
        self.eps = eps
        self.project = _resolve_project(project)

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

    def __init__(self, factor: int | Sequence[int] = (0, 1), eps: float = EPS, **kwargs: Any) -> None:
        super().__init__(factor=factor)
        self.eps = eps

    def update_u(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        a, b = x @ v, _mT(v) @ v
        return (u * a + self.eps) / (u @ b + self.eps)


class FastMultiplicativeUpdate(BCDSolver):
    """The multiplicative update written as einsums (the contraction order left to ``torch.einsum``)."""

    def __init__(self, factor: int | Sequence[int] = (0, 1), eps: float = EPS, **kwargs: Any) -> None:
        super().__init__(factor=factor)
        self.eps = eps

    def update_u(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        numerator = torch.einsum("...ij,...ir,...jr->...ir", x, u, v) + self.eps
        denominator = torch.einsum("...is,...js,...jr->...ir", u, v, v) + self.eps
        return numerator / denominator

    def update_v(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        numerator = torch.einsum("...ij,...ir,...jr->...jr", x, u, v) + self.eps
        denominator = torch.einsum("...ir,...is,...js->...jr", u, u, v) + self.eps
        return numerator / denominator


class WeightedMultiplicativeUpdate(BCDSolver):
    """Multiplicative update for weighted NMF: ``min ||W ⊙ (X - U Vᵀ)||²`` (``w`` None: all ones)."""

    def __init__(self, factor: int | Sequence[int] = (0, 1), eps: float = EPS, **kwargs: Any) -> None:
        super().__init__(factor=factor)
        self.eps = eps

    def update_u(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        numerator = u * ((w * x) @ v) + self.eps
        denominator = (w * (u @ _mT(v))) @ v + self.eps
        return numerator / denominator

    def update_v(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.update_u(_mT(x), v, u, _mT(w))

    def __call__(self, x: torch.Tensor, factors: Factors, w: Optional[torch.Tensor] = None, **kwargs: Any) -> Factors:
        u, v = factors
        w = torch.ones_like(x) if w is None else w
        for j in self.factor:
            if j == 0:
                u = self.update_u(x, u, v, w)
            else:
                v = self.update_v(x, u, v, w)
        return u, v


class SemiMultiplicativeUpdate(BCDSolver):
    """Multiplicative update for semi-NMF (only U is constrained nonnegative)."""

    def __init__(self, factor: int | Sequence[int] = (0, 1), eps: float = EPS, **kwargs: Any) -> None:
        super().__init__(factor=factor)
        self.eps = eps

    def update_u(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        a, b = x @ v, _mT(v) @ v
        numerator = torch.relu(a) + u @ torch.relu(-b) + self.eps
        denominator = torch.relu(-a) + u @ torch.relu(b) + self.eps
        return u * torch.sqrt(numerator / denominator)


class Compose(BCDSolver):
    """Several solvers in sequence within one iteration; each is built with the same keyword arguments."""

    def __init__(self, solvers: Optional[Sequence] = None, **kwargs: Any) -> None:
        solvers = [] if solvers is None else as_tuple(solvers)
        self.solvers = [partialize(s)(**kwargs) for s in solvers]
        self.factor = [s.factor for s in self.solvers]
        self.size = kwargs.get("size")
        self.rank = kwargs.get("rank")

    def __call__(self, x: torch.Tensor, factors: Factors, *args: Any, **kwargs: Any) -> Factors:
        u, v = factors
        for solver in self.solvers:
            u, v = solver(x, (u, v))
        return u, v

    def __getitem__(self, idx: int) -> BCDSolver:
        return self.solvers[idx]

    def __len__(self) -> int:
        return len(self.solvers)


# The registry, name for name the JAX package's.  "wmu-0" / "wmu-1" dispatch to the plain MultiplicativeUpdate there,
# and so they do here.
SOLVER_DISPATCH_MAP: dict[str, Any] = {
    "mu": MultiplicativeUpdate,
    "mu-0": (MultiplicativeUpdate, {"factor": 0}),
    "mu-1": (MultiplicativeUpdate, {"factor": 1}),
    "fmu": FastMultiplicativeUpdate,
    "fmu-0": (FastMultiplicativeUpdate, {"factor": 0}),
    "fmu-1": (FastMultiplicativeUpdate, {"factor": 1}),
    "wmu": WeightedMultiplicativeUpdate,
    "wmu-0": (MultiplicativeUpdate, {"factor": 0}),
    "wmu-1": (MultiplicativeUpdate, {"factor": 1}),
    "smu": SemiMultiplicativeUpdate,
    "smu-0": (SemiMultiplicativeUpdate, {"factor": 0}),
    "smu-1": (SemiMultiplicativeUpdate, {"factor": 1}),
    "cd": CoordinateDescent,
    "cd-0": (CoordinateDescent, {"factor": 0}),
    "cd-1": (CoordinateDescent, {"factor": 1}),
    "nncd": (CoordinateDescent, {"project": torch.relu}),
    "nncd-0": (CoordinateDescent, {"factor": 0, "project": torch.relu}),
    "nncd-1": (CoordinateDescent, {"factor": 1, "project": torch.relu}),
    "hals": (CoordinateDescent, {"project": torch.relu}),
    "hals-0": (CoordinateDescent, {"factor": 0, "project": torch.relu}),
    "hals-1": (CoordinateDescent, {"factor": 1, "project": torch.relu}),
    "ls": LeastSquares,
    "ls-0": (LeastSquares, {"factor": 0}),
    "ls-1": (LeastSquares, {"factor": 1}),
    "nnls": (LeastSquares, {"project": torch.relu}),
    "nnls-0": (LeastSquares, {"factor": 0, "project": torch.relu}),
    "nnls-1": (LeastSquares, {"factor": 1, "project": torch.relu}),
}


def parse_solver(obj: Any) -> Any:
    """A solver spec (a registry name, a partializable, or a sequence of these, composed) as a partializable."""
    if is_partializable(obj):
        return obj
    if isinstance(obj, str):
        return SOLVER_DISPATCH_MAP.get(obj, obj)
    if isinstance(obj, Sequence):
        out = []
        for x in obj:
            if is_partializable(x):
                out.append(x)
            elif isinstance(x, str):
                out.append(SOLVER_DISPATCH_MAP.get(x, x))
            else:
                raise ValueError(f"Cannot parse solver element {x!r}.")
        return (Compose, {"solvers": out})
    raise ValueError(f"Cannot parse solver {obj!r}.")
