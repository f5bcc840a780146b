"""Truncated randomized SVD layer and the auto-rank rule.

PyTorch counterpart of ``factorizer_tpu/factorization/svd.py``: the
randomized subspace iteration of Halko et al., batched over the leading axes,
differentiable, with the small QR and SVD factorizations in ``torch.linalg``.
At rank 1 the QR of one column and the SVD of one row are written out in
elementwise operations, with LAPACK's Householder sign convention (the CPU's
``torch.linalg`` and the JAX package's give the same factors): for these
shapes ``torch.linalg`` loops cuSOLVER over the batch on the card, 8.5 s for
the QR of 131072 columns of 8 and 16.7 s for the SVD of 131072 rows of 512 on
an H100 80GB HBM3 at 700 W (``tools/time_engine_linalg.py``), where a mixer at
stage 0 of ``factorizer_brats23`` needs five QRs and one SVD.
The Gaussian test matrix is drawn from a CPU generator seeded with ``seed``
(:func:`gaussian`) and then moved to the input's device, so the card and the
CPU see the same draw; every call draws the same matrix, so the last few
draws are kept (drawing the 67 M numbers of stage 0's test matrix on the host
takes longer than the whole randomized SVD on the card).  The JAX package draws it from
``jax.random.key(seed)``; the two draws differ, and so do the results wherever
they depend on the draw (they do not for matrices of rank at most ``rank``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.math import relative_error

__all__ = ["SVD", "gaussian", "infer_rank", "randomized_svd"]


def infer_rank(size: Sequence[int], rank: Optional[int], compression: Optional[float]) -> tuple[int, float]:
    """The auto-rank rule ``rank = ceil(M*N / (compression*(M+N)))`` when ``rank`` is None.

    Returns the resolved ``(rank, achieved_compression)``; raises when both are None.
    """
    M, N = size
    if (rank, compression) == (None, None):
        raise ValueError("'rank' or 'compression' must be specified.")
    df_input = M * N
    df_lowrank = M + N
    if rank is None:
        rank = max(math.ceil(df_input / (compression * df_lowrank)), 1)
    return rank, df_input / (rank * df_lowrank)


@functools.lru_cache(maxsize=16)
def gaussian(shape: tuple[int, ...], dtype: torch.dtype, device: torch.device, seed: int) -> torch.Tensor:
    """The test matrix of :func:`randomized_svd`: standard normal entries from a CPU generator seeded with ``seed``,
    on ``device``.  The same arguments return the same tensor, which callers do not modify; it is made outside
    inference mode, so a draw first made while serving can be saved for a backward later."""
    with torch.inference_mode(False):
        draw = torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=dtype)
        return draw.to(device)


def _householder(y: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """LAPACK's reflection of the vectors along ``dim`` onto the first axis vector: ``(d, y / d)``.

    ``d = -sign(y_0) |y|`` (the sign of 0 is +), except where the tail ``y_1..`` is zero: there nothing is
    reflected, ``d = y_0`` and the unit vector is ``e_1`` (also for ``y = 0``).
    """
    head = y.narrow(dim, 0, 1)
    tail_zero = torch.linalg.vector_norm(y.narrow(dim, 1, y.shape[dim] - 1), dim=dim, keepdim=True) == 0
    norm = torch.linalg.vector_norm(y, dim=dim, keepdim=True)
    d = torch.where(tail_zero, head, torch.where(head >= 0, -norm, norm))
    e1 = torch.zeros_like(y)
    e1.narrow(dim, 0, 1).fill_(1)
    return d, torch.where(tail_zero, e1, y / torch.where(tail_zero, torch.ones_like(d), d))


def _orth(y: torch.Tensor) -> torch.Tensor:
    """Q of the reduced QR of ``y (..., M, R)``; one column in closed form."""
    if y.shape[-1] != 1:
        return torch.linalg.qr(y).Q
    return _householder(y, -2)[1]


def _svd(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Thin SVD ``(u, s, vᵀ)`` of ``b (..., R, N)``; one row in closed form: ``u = sign(d)``, ``s = |d|``."""
    if b.shape[-2] != 1:
        return torch.linalg.svd(b, full_matrices=False)
    d, vt = _householder(b, -1)
    return torch.where(d >= 0, 1.0, -1.0).to(b.dtype), d.abs()[..., 0], vt


def randomized_svd(x: torch.Tensor, rank: int, niter: int = 2, seed: int = 42) -> tuple[torch.Tensor, ...]:
    """Batched randomized truncated SVD of ``x (..., M, N)`` by subspace iteration.

    Returns ``(u, s, v)`` with ``u: (..., M, R)``, ``s: (..., R)``, ``v: (..., N, R)``.  Half precision raises,
    as ``torch.linalg`` (and the JAX package's) QR does not take it.
    """
    if x.dtype in (torch.bfloat16, torch.float16):
        raise NotImplementedError(f"Unsupported dtype {str(x.dtype).removeprefix('torch.')}")
    *batch, M, N = x.shape
    omega = gaussian((*batch, N, rank), x.dtype, x.device, seed)
    q = _orth(x @ omega)
    for _ in range(niter):
        q = _orth(x.transpose(-1, -2) @ q)
        q = _orth(x @ q)
    b = q.transpose(-1, -2) @ x  # (..., R, N)
    u_b, s, vt = _svd(b)
    return q @ u_b, s, vt.transpose(-1, -2)


class SVD(nn.Module):
    """Truncated randomized SVD layer; ``forward`` returns the rank-``rank`` reconstruction.

    Args:
        size: ``(M, N)`` of the matrices.
        rank: target rank; inferred from ``compression`` if None.
        compression: target compression of the auto-rank rule.
        no_grad: detach the decomposition.
        niter: power iterations.
        seed: seed of the test matrix, the same on every call.
    """

    def __init__(
        self,
        size: Sequence[int],
        rank: Optional[int] = None,
        compression: float = 10,
        no_grad: bool = False,
        niter: int = 2,
        seed: int = 42,
        verbose: bool = False,
    ) -> None:
        super().__init__()
        self.size = tuple(size)
        self.no_grad = no_grad
        self.niter = niter
        self.seed = seed
        self.rank, self.compression = infer_rank(self.size, rank, compression)
        self.verbose = verbose

    def decompose(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        u, s, v = randomized_svd(x, self.rank, niter=self.niter, seed=self.seed)
        if self.no_grad:
            u, s, v = u.detach(), s.detach(), v.detach()
        return u, s, v

    def reconstruct(self, u: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return (u * s[..., None, :]) @ v.transpose(-1, -2)

    def loss(self, x: torch.Tensor, u: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return relative_error(x, self.reconstruct(u, s, v))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reconstruct(*self.decompose(x))
