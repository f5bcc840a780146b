"""Factor-matrix initializers.

PyTorch counterpart of ``factorizer_tpu/factorization/inits.py``.
``RandomInit``'s shared, non-trainable ``u0``/``v0`` tables are registered
buffers, drawn once from an explicit ``torch.Generator`` (``u0`` first) and
broadcast to the input's batch dims; ``method`` names one sampler for both or
one for each.  ``SVDInit`` and ``NNDSVDInit`` hold no state: they start from a
truncated randomized SVD of the input (``factorization.svd``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..utils.helpers import as_tuple, is_partializable
from .svd import SVD

__all__ = ["RandomInit", "SVDInit", "NNDSVDInit", "INIT_DISPATCH_MAP", "parse_init"]

_SAMPLERS = {
    "uniform": lambda shape, g: torch.rand(shape, generator=g),
    "normal": lambda shape, g: torch.randn(shape, generator=g),
}


class RandomInit(nn.Module):
    """Random factors ``(u0, v0)`` of shapes ``(M, R)`` / ``(N, R)``, shared across the batch.

    ``method``: ``"uniform"``, ``"normal"``, or a pair naming ``u0``'s sampler and ``v0``'s.  The tables are drawn on
    the CPU from ``generator`` and then moved to ``device``, so one seed gives the same tables on every device.
    """

    def __init__(
        self,
        size: Sequence[int],
        rank: int,
        method: Any = "uniform",
        device: Optional[torch.device] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        methods = as_tuple(method)
        if len(methods) == 1:
            mu = mv = methods[0]
        elif len(methods) == 2:
            mu, mv = methods
        else:
            raise ValueError("`method` not valid.")
        self.method = (mu, mv)
        self.register_buffer("u0", _SAMPLERS[mu]((size[0], rank), generator).to(device))
        self.register_buffer("v0", _SAMPLERS[mv]((size[1], rank), generator).to(device))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        batch = x.shape[:-2]
        u = self.u0.to(x.dtype).expand(*batch, *self.u0.shape)
        v = self.v0.to(x.dtype).expand(*batch, *self.v0.shape)
        return u, v


class SVDInit:
    """Factors from a truncated SVD: ``u = U√s``, ``v = V√s``.  Their signs are those of the singular vectors."""

    def __init__(self, size: Sequence[int], rank: Optional[int] = None, **kwargs: Any) -> None:
        self.svd = SVD(size=size, rank=rank)

    def __call__(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        u, s, v = self.svd.decompose(x)
        s = torch.sqrt(s)[..., None, :]
        return u * s, v * s


class NNDSVDInit:
    """Nonnegative double SVD initialization (Boutsidis & Gallopoulos).

    Per rank and matrix it keeps the sign pattern of the singular-vector pair
    that carries more mass, so the result does not depend on the vectors' signs.
    """

    def __init__(self, size: Sequence[int], rank: Optional[int] = None, **kwargs: Any) -> None:
        self.svd = SVD(size=size, rank=rank)

    def __call__(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        u, s, v = self.svd.decompose(x)
        s = torch.sqrt(s)[..., None, :]
        u, v = u * s, v * s
        u_cols, v_cols = [], []
        for r in range(self.svd.rank):
            a, b = u[..., :, r], v[..., :, r]
            ap, an, bp, bn = torch.relu(a), torch.relu(-a), torch.relu(b), torch.relu(-b)
            abp = torch.linalg.vector_norm(ap, dim=-1) * torch.linalg.vector_norm(bp, dim=-1)
            abn = torch.linalg.vector_norm(an, dim=-1) * torch.linalg.vector_norm(bn, dim=-1)
            mask = (abp >= abn)[..., None]
            u_cols.append(torch.where(mask, ap, an))
            v_cols.append(torch.where(mask, bp, bn))
        return torch.stack(u_cols, dim=-1), torch.stack(v_cols, dim=-1)


INIT_DISPATCH_MAP: dict[str, Any] = {
    "uniform": (RandomInit, {"method": "uniform"}),
    "normal": (RandomInit, {"method": "normal"}),
    "normal-uniform": (RandomInit, {"method": ("normal", "uniform")}),
    "uniform-normal": (RandomInit, {"method": ("uniform", "normal")}),
    "svd": SVDInit,
    "nndsvd": NNDSVDInit,
}


def parse_init(obj: Any) -> Any:
    """An initializer spec (a registry name or a partializable) as a partializable."""
    if isinstance(obj, str):
        return INIT_DISPATCH_MAP.get(obj, obj)
    if is_partializable(obj):
        return obj
    raise ValueError(f"Cannot parse init {obj!r}.")
