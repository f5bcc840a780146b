"""Differentiable matrix-factorization layers (MF / NMF).

PyTorch counterpart of ``factorizer_tpu/factorization/nmf.py``.  The first
``num_iters - num_grad_steps`` iterations consume ``x.detach()``, so the
factors entering the differentiable tail are constants for autograd, as the
JAX package's ``stop_gradient`` phase makes them.  The rank comes from
``rank``, or from ``compression`` by the auto-rank rule (``svd.infer_rank``);
the initializer and the solver from their specs (``inits.parse_init``,
``solvers.parse_solver``).

``forward`` has two routes, chosen by configuration and shape, never by the
input's dtype or device.  The flat kernel K4 (``ops.kernels.nmf_reconstruct``)
takes a batch of matrices (``x.ndim >= 3``) under the JAX package's rule for
its fused kernel: the solver the string ``"hals"`` or ``"mu"``, no
``project``, a ``RandomInit``, a rank and size the kernel covers
(``ops.kernels.nmf.supports``: rank 1 to 4, a launch plan), and ``use_pallas``
not False (JAX's pure-XLA mode, here the stock chain).  There it runs on
the card, reads f32, bf16 or f16 and solves in f32 on chip; on the CPU its
plain version runs.  Everything else (an SVD init, ``nncd``, a composed or
projected solver, the default global ``Matricize``) takes the ``decompose``
chain, where bf16 and f16 inputs are solved in float32 and the reconstruction
is cast back.  A few rank-1 sizes fit the forward kernel but not the backward
kernel (``ops.kernels.nmf.supports_backward``): they are served through K4 and
take the ``decompose`` chain only when a gradient with respect to the input is
being recorded.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..ops.kernels import nmf as nmf_kernel
from ..ops.math import relative_error
from ..utils.helpers import build_spec, partialize
from .inits import RandomInit, parse_init
from .solvers import EPS, parse_solver
from .svd import infer_rank

__all__ = ["MatrixFactorization", "NMF", "translate_mf_kwargs"]


def translate_mf_kwargs(kwargs: dict[str, Any]) -> dict[str, Any]:
    """The reference's ``init=`` keyword as ``init_method=`` (the JAX package renamed it; so does this port)."""
    kwargs = dict(kwargs)
    if "init" in kwargs:
        kwargs.setdefault("init_method", kwargs.pop("init"))
    return kwargs


class MatrixFactorization(nn.Module):
    """``X ≈ U Vᵀ`` over the trailing two axes; ``forward`` returns ``U Vᵀ``.

    Args:
        size: ``(M, N)`` of the factorized matrices.
        rank: factorization rank; None takes the auto-rank rule at ``compression``.
        compression: target compression of the auto-rank rule.
        init_method: initializer spec: ``"uniform" | "normal" | "normal-uniform" | "uniform-normal" | "svd" |
            "nndsvd"``, a class, or ``(class, kwargs)``.
        solver: solver spec: a registry name (``"cd"``, the default, ``"hals"``, ``"mu"``, ``"nnls"``, ...), a
            class, ``(class, kwargs)``, or a sequence of these (composed).
        num_iters: number of BCD iterations.
        num_grad_steps: trailing iterations that are differentiable (None = all).
        eps: the solvers' regulariser (None: theirs, 1e-16).
        project: projection passed to the solver (None: the solver's own).
        use_pallas: the JAX package's keyword.  False takes the ``decompose`` chain always, as JAX's pure-XLA mode
            does, so K4 never runs.  None (JAX's auto) and True keep the rule above: the port chooses by
            configuration, never by platform, so JAX's "True forces the kernel off the TPU" and "None: the kernel
            on a TPU" are one rule here.
        device, generator: where ``RandomInit`` puts its tables, and what it draws them from.
    """

    def __init__(
        self,
        size: Sequence[int],
        rank: Optional[int] = None,
        compression: float = 10.0,
        init_method: Any = "normal",
        solver: Any = "cd",
        num_iters: int = 5,
        num_grad_steps: Optional[int] = None,
        eps: Optional[float] = None,
        project: Any = None,
        verbose: bool = False,
        use_pallas: Optional[bool] = None,
        device: Optional[torch.device] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.size = tuple(size)
        self.rank, self.compression = rank, compression
        self.rank_, self.compression_ = infer_rank(self.size, rank, compression)
        self.init_method, self.solver = init_method, solver
        self.num_iters, self.num_grad_steps = num_iters, num_grad_steps
        self.eps, self.project, self.verbose, self.use_pallas = eps, project, verbose, use_pallas

        self.init = build_spec(parse_init(init_method), size=self.size, rank=self.rank_,
                               context={"device": device, "generator": generator})
        opts: dict[str, Any] = {"size": self.size, "rank": self.rank_}
        if eps is not None:
            opts["eps"] = eps
        if project is not None:
            opts["project"] = project
        self.solver_ = partialize(parse_solver(solver))(**opts)

    @property
    def kernel_eps(self) -> float:
        """The regulariser the kernels are given: ``eps``, or the solvers' default."""
        return EPS if self.eps is None else self.eps

    def decompose(self, x: torch.Tensor, *args: Any, **kwargs: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """The initializer and ``num_iters`` solver iterations on ``x (..., M, N)``: ``u (..., M, R)``, ``v (..., N, R)``.

        Further arguments go to the solver (``w=`` to ``WeightedMultiplicativeUpdate``).
        """
        num_grad = self.num_iters if self.num_grad_steps is None else self.num_grad_steps
        k = self.num_iters - num_grad  # leading iterations outside autograd
        x_ng = x.detach()
        u, v = self.init(x_ng if k >= 0 else x)
        for it in range(1, self.num_iters + 1):
            u, v = self.solver_(x_ng if it <= k else x, (u, v), *args, **kwargs)
        return u, v

    def reconstruct(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return u @ v.transpose(-1, -2)

    def loss(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
        return relative_error(x, self.reconstruct(u, v), w)

    def supports(self, backward: bool = False) -> bool:
        """Whether K4 computes this configuration (the JAX package's rule for its fused kernel, and the kernel's
        rank, size and iterations), and with ``backward`` whether its gradient can be had there too.  Never under
        ``use_pallas=False``."""
        if not (self.use_pallas is not False and isinstance(self.solver, str) and self.solver in nmf_kernel.SOLVERS
                and self.project is None and isinstance(self.init, RandomInit)):
            return False
        rule = nmf_kernel.supports_backward if backward else nmf_kernel.supports
        return rule(self.solver, self.rank_, self.size, self.num_iters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        differentiated = torch.is_grad_enabled() and x.requires_grad
        if x.ndim >= 3 and self.supports(backward=differentiated):
            return nmf_kernel.nmf_reconstruct(
                x.contiguous(), self.init.u0, self.init.v0, self.solver, self.num_iters, self.kernel_eps,
                self.num_grad_steps,
            )
        if x.dtype in (torch.bfloat16, torch.float16):
            u, v = self.decompose(x.float())
            return self.reconstruct(u, v).to(x.dtype)
        return self.reconstruct(*self.decompose(x))


class NMF(MatrixFactorization):
    """Nonnegative ``X ≈ U Vᵀ``: uniform init and HALS by default."""

    def __init__(
        self,
        size: Sequence[int],
        rank: Optional[int] = None,
        compression: float = 10.0,
        init_method: Any = "uniform",
        solver: Any = "hals",
        num_iters: int = 5,
        num_grad_steps: Optional[int] = None,
        eps: Optional[float] = None,
        project: Any = None,
        verbose: bool = False,
        use_pallas: Optional[bool] = None,
        device: Optional[torch.device] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__(size, rank, compression, init_method, solver, num_iters, num_grad_steps, eps, project,
                         verbose, use_pallas, device, generator)
