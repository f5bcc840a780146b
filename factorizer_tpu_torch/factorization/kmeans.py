"""Differentiable (truncated-gradient) clustering layers.

PyTorch counterpart of ``factorizer_tpu/factorization/kmeans.py``: ``KMeans``,
``FuzzyCMeans`` and ``EntropyKMeans`` on points ``x (..., M, N)`` (M points of
N features per batch element).  The centers start at the points that Python's
``random.Random(seed).sample`` picks, as in the JAX package; the first
``num_iters - num_grad_steps`` iterations see ``x.detach()``.
"""

from __future__ import annotations

import math
import random
from typing import Any, Optional

import torch
import torch.nn.functional as F

__all__ = ["KMeans", "FuzzyCMeans", "EntropyKMeans"]


class KMeans:
    """Batched k-means: hard memberships ``u (..., M, K)`` and centers ``v (..., K, N)``."""

    def __init__(
        self,
        num_centers: int,
        num_iters: int = 10,
        num_grad_steps: Optional[int] = None,
        eps: float = 1e-16,
        seed: int = 42,
        verbose: bool = False,
        *args: Any,
        **kwargs: Any,
    ) -> None:
        self.num_centers = num_centers
        self.num_iters = num_iters
        self.num_grad_steps = num_iters if num_grad_steps is None else num_grad_steps
        self.eps = eps
        self.seed = seed
        self.verbose = verbose

    @staticmethod
    def get_dist(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Squared Euclidean distances between the rows of ``x (..., M, N)`` and the centers ``v (..., K, N)``."""
        x2 = x.square().sum(-1, keepdim=True)
        xv = x @ v.transpose(-1, -2)
        v2 = v.square().sum(-1)[..., None, :]
        return torch.relu(x2 - 2 * xv + v2)

    def get_clusters(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.get_dist(x, v).argmin(-1)

    def update_u(self, x: torch.Tensor, u: Optional[torch.Tensor], v: torch.Tensor) -> torch.Tensor:
        """Hard memberships: one-hot of the nearest center, in ``x``'s dtype."""
        return F.one_hot(self.get_clusters(x, v), self.num_centers).to(x.dtype)

    def update_v(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Membership-weighted centroids (``u`` normalised over the points)."""
        u = (u + self.eps) / (u.sum(-2, keepdim=True) + self.eps)
        return u.transpose(-1, -2) @ x

    def update(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        u = self.update_u(x, u, v)
        return u, self.update_v(x, u, v)

    def initialize(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        inds = random.Random(self.seed).sample(range(x.shape[-2]), self.num_centers)
        v = x[..., inds, :]
        return self.update_u(x, None, v), v

    def loss(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        d_avg = (self.get_dist(x, v) * u).sum((-2, -1))
        return d_avg / (u.shape[-2] * u.shape[-1])

    def __call__(self, x: torch.Tensor, *args: Any, **kwargs: Any) -> tuple[torch.Tensor, torch.Tensor]:
        k = self.num_iters - self.num_grad_steps  # leading iterations outside autograd
        x_ng = x.detach()
        u, v = self.initialize(x_ng if k >= 0 else x)
        for it in range(1, self.num_iters + 1):
            u, v = self.update(x_ng if it <= k else x, u, v)
        return u, v

    forward = __call__


class FuzzyCMeans(KMeans):
    """Fuzzy c-means: soft memberships with fuzzifier ``m``."""

    def __init__(self, m: float = 2, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.m = m

    def update_u(self, x: torch.Tensor, u: Optional[torch.Tensor], v: torch.Tensor) -> torch.Tensor:
        u = (self.get_dist(x, v) + self.eps) ** (1.0 / (1.0 - self.m))
        u = (u + self.eps) / (u.sum(-1, keepdim=True) + self.eps)
        return u**self.m


class EntropyKMeans(KMeans):
    """Entropy-regularised k-means: softmax memberships at temperature ``alpha``."""

    def __init__(self, alpha: float = 0.001, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.alpha = alpha

    def update_u(self, x: torch.Tensor, u: Optional[torch.Tensor], v: torch.Tensor) -> torch.Tensor:
        return torch.softmax(-self.get_dist(x, v) / self.alpha, dim=-1)

    def loss(self, x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        d = self.get_dist(x, v)
        h = torch.where(u > self.eps, u * torch.log(u.clamp(min=self.eps)), torch.zeros((), dtype=u.dtype, device=u.device))
        h = h + (1.0 / self.num_centers) * math.log(self.num_centers)
        loss = u * d + self.alpha * h
        return loss.sum((-2, -1)) / (u.shape[-2] * u.shape[-1])
