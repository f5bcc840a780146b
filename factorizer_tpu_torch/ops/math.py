"""Batched math primitives used by the factorization layers.

PyTorch counterpart of ``factorizer_tpu/ops/math.py``: ``dot``, ``norm2``,
``softmax`` over one or several axes, ``relative_error`` and ``kl_divergence``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["dot", "norm2", "softmax", "relative_error", "kl_divergence", "EPS"]

EPS = 1e-16


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched Frobenius inner product over the last two axes: ``(..., M, N)`` -> ``(..., 1)``."""
    return (x * y).sum((-2, -1))[..., None]


def norm2(x: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (optionally weighted) L2 norm of ``x (B, ...)`` over all non-batch axes: a vector of length ``B``."""
    y = x.square().flatten(1)
    if w is not None:
        y = y * w.flatten(1)
    return y.sum(1).sqrt()


def softmax(x: torch.Tensor, axis: int | Sequence[int]) -> torch.Tensor:
    """Softmax normalised jointly over one or several axes."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % x.ndim for a in axes)
    e = torch.exp(x - x.amax(axes, keepdim=True))
    return e / e.sum(axes, keepdim=True)


def relative_error(x: torch.Tensor, y: torch.Tensor, w: Optional[torch.Tensor] = None, eps: float = EPS) -> torch.Tensor:
    """Batched relative error ``|x - y| / |x|`` in the (weighted) L2 norm."""
    return (norm2(x - y, w) + eps) / (norm2(x, w) + eps)


def kl_divergence(x: torch.Tensor, y: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Batched generalised KL divergence ``x log(x/y) - x + y``, averaged over all non-batch elements."""
    x = x.clamp(min=eps)
    y = y.clamp(min=eps)
    kl = x * torch.log(x / y) - x + y
    return kl.flatten(1).mean(-1)
