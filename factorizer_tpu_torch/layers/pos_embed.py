"""Learnable positional embedding for channels-last volumes.

PyTorch counterpart of ``PositionalEmbedding`` in
``factorizer_tpu/layers/pos_embed.py``.  The table is stored as the reference
torch model stores it, ``pos: (1, C, *S)``, and added in channels-last order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["PositionalEmbedding"]


class PositionalEmbedding(nn.Module):
    """Learnable additive embedding ``pos ~ N(0, 1)`` of shape ``(1, C, *S)``."""

    def __init__(
        self,
        channels: int,
        spatial_size: Sequence[int],
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        pos = torch.randn((1, channels, *spatial_size), generator=generator)
        self.pos = nn.Parameter(pos.to(device))

    def forward(self, x: torch.Tensor, rows: Optional[slice] = None) -> torch.Tensor:
        """``x + pos``; ``rows`` selects the rows of the first spatial axis that ``x``, a slab of the volume, holds."""
        pos = self.pos if rows is None else self.pos[:, :, rows]
        return x + pos.movedim(1, -1).to(x.dtype)
