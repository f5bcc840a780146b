"""Batched norms and errors used by the factorization layers.

PyTorch counterpart of ``norm2`` and ``relative_error`` in
``factorizer_tpu/ops/math.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["norm2", "relative_error", "EPS"]

EPS = 1e-16


def norm2(x: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (optionally weighted) L2 norm of ``x (B, ...)`` over all non-batch axes: a vector of length ``B``."""
    y = x.square().flatten(1)
    if w is not None:
        y = y * w.flatten(1)
    return y.sum(1).sqrt()


def relative_error(x: torch.Tensor, y: torch.Tensor, w: Optional[torch.Tensor] = None, eps: float = EPS) -> torch.Tensor:
    """Batched relative error ``|x - y| / |x|`` in the (weighted) L2 norm."""
    return (norm2(x - y, w) + eps) / (norm2(x, w) + eps)
