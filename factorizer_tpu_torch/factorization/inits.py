"""Factor-matrix initializers.

PyTorch counterpart of ``RandomInit`` in ``factorizer_tpu/factorization/inits.py``:
the shared, non-trainable ``u0``/``v0`` tables are registered buffers, drawn once
from an explicit ``torch.Generator`` and broadcast to the input's batch dims.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["RandomInit"]

_SAMPLERS = {
    "uniform": lambda shape, g: torch.rand(shape, generator=g),
    "normal": lambda shape, g: torch.randn(shape, generator=g),
}


class RandomInit(nn.Module):
    """Random factors ``(u0, v0)`` of shapes ``(M, R)`` / ``(N, R)``, shared across the batch.

    The tables are drawn on the CPU from ``generator`` and then moved to
    ``device``, so one seed gives the same tables on every device.
    """

    def __init__(
        self,
        size: Sequence[int],
        rank: int,
        method: str = "uniform",
        device: Optional[torch.device] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        sample = _SAMPLERS[method]
        self.register_buffer("u0", sample((size[0], rank), generator).to(device))
        self.register_buffer("v0", sample((size[1], rank), generator).to(device))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        batch = x.shape[:-2]
        u = self.u0.to(x.dtype).expand(*batch, *self.u0.shape)
        v = self.v0.to(x.dtype).expand(*batch, *self.v0.shape)
        return u, v
