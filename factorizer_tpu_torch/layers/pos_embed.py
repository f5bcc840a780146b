"""Positional embeddings for channels-last volumes.

PyTorch counterpart of ``factorizer_tpu/layers/pos_embed.py``.  The learnable
tables are stored as the reference torch model stores them, channels first:
``pos: (1, C, *S)`` and the axial ``pe{i}: (1, C, 1, .., S_i, .., 1)``; they are
added in channels-last order.  The fixed sinusoidal and rotary tables are
computed once, in float64 as the JAX package computes them, kept channels-last
as buffers outside the ``state_dict``, and cast to the input's dtype.  Every
embedding's ``forward(x, rows)`` takes ``rows``, the rows of the first spatial
axis that ``x``, a slab of the volume, holds.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

__all__ = [
    "SinusoidalPositionalEmbedding",
    "RotaryPositionalEmbedding",
    "PositionalEmbedding",
    "PosEmbed",
    "AxialPositionalEmbedding",
]


def _angle_table(channels: int, spatial_size: Sequence[int]) -> np.ndarray:
    """``theta[s1..sp, c/2] = sum over the axes of position * freq_c``, float64."""
    p = len(spatial_size)
    freqs = np.exp(np.arange(0, channels, 2) * (-math.log(10000.0) / channels))
    theta = np.zeros((*spatial_size, len(freqs)), dtype=np.float32)
    for axis, size in enumerate(spatial_size):
        pos = np.arange(size, dtype=np.float32).reshape(*[size if j == axis else 1 for j in range(p)], 1)
        theta = theta + pos * freqs.reshape(*([1] * p), -1)
    return theta


def _rows(table: torch.Tensor, rows: Optional[slice], axis: int) -> torch.Tensor:
    """``table`` cut to ``rows`` along ``axis`` where it spans the first spatial axis (an axial table of size 1 is not)."""
    if rows is None or table.shape[axis] == 1:
        return table
    index = [slice(None)] * table.ndim
    index[axis] = rows
    return table[tuple(index)]


class SinusoidalPositionalEmbedding(nn.Module):
    """Additive fixed sinusoidal embedding: ``x + [cos θ, sin θ]``."""

    def __init__(self, channels: int, spatial_size: Sequence[int], device=None, generator=None) -> None:
        super().__init__()
        theta = _angle_table(channels, tuple(spatial_size))
        pe = np.concatenate([np.cos(theta), np.sin(theta)], axis=-1)[None]
        self.register_buffer("pe", torch.from_numpy(pe).to(device), persistent=False)

    def forward(self, x: torch.Tensor, rows: Optional[slice] = None) -> torch.Tensor:
        return x + _rows(self.pe, rows, 1).to(x.dtype)


class RotaryPositionalEmbedding(nn.Module):
    """Rotary embedding over the two halves of the channels: ``cos θ · x + sin θ · [-x2, x1]``."""

    def __init__(self, channels: int, spatial_size: Sequence[int], device=None, generator=None) -> None:
        super().__init__()
        theta = _angle_table(channels, tuple(spatial_size))
        theta = np.concatenate([theta, theta], axis=-1)[None]
        self.register_buffer("cos", torch.from_numpy(np.cos(theta)).to(device), persistent=False)
        self.register_buffer("sin", torch.from_numpy(np.sin(theta)).to(device), persistent=False)

    def forward(self, x: torch.Tensor, rows: Optional[slice] = None) -> torch.Tensor:
        d = x.shape[-1]
        x_half = torch.cat([-x[..., d // 2 :], x[..., : d // 2]], dim=-1)
        return _rows(self.cos, rows, 1).to(x.dtype) * x + _rows(self.sin, rows, 1).to(x.dtype) * x_half


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
        return x + _rows(self.pos, rows, 2).movedim(1, -1).to(x.dtype)


PosEmbed = PositionalEmbedding  # the reference's alias


class AxialPositionalEmbedding(nn.Module):
    """Learnable per-axis additive embeddings ``pe{i} ~ N(0, 1)`` of shape ``(1, C, 1, .., S_i, .., 1)``."""

    def __init__(
        self,
        channels: int,
        spatial_size: Sequence[int],
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        p = len(spatial_size)
        self.n_axes = p
        for axis, size in enumerate(spatial_size):
            shape = (1, channels, *[size if j == axis else 1 for j in range(p)])
            self.register_parameter(f"pe{axis}", nn.Parameter(torch.randn(shape, generator=generator).to(device)))

    def forward(self, x: torch.Tensor, rows: Optional[slice] = None) -> torch.Tensor:
        out = x
        for axis in range(self.n_axes):
            out = out + _rows(getattr(self, f"pe{axis}"), rows, 2).movedim(1, -1).to(x.dtype)
        return out
