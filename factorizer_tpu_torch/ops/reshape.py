"""Matricize / shifted-window matricize on torch tensors.

PyTorch counterpart of ``factorizer_tpu/ops/reshape.py``.  Channels-last
volumes ``(B, *S, C)``, the layout inside the port's models, are the default
here (the JAX package defaults to channels-first); ``data_format=
"channels_first"`` takes ``(B, C, *S)``.  The channels-last fold is the einops
equation ``b (g0 p0)(g1 p1)(g2 p2)(h d) -> (b h)(g0 g1 g2) d (p0 p1 p2)``
(the patch index is ``p0``-major and ``d`` is the minor part of the channel
index), preceded by ``torch.roll(+shift)`` over the spatial axes and undone
exactly by the inverse equation and ``torch.roll(-shift)``.

This is the plain mixer path and the oracle for the windowed-NMF kernel
(``ops/kernels/windowed_nmf.py``), which computes the same fold without ever
materialising it.
"""

from __future__ import annotations

import re
from math import prod
from typing import Optional, Sequence

import torch
from einops import rearrange

from ..utils.helpers import to_ntuple

__all__ = ["Reshape", "Matricize", "SWMatricize"]

CHANNELS_FIRST = "channels_first"
CHANNELS_LAST = "channels_last"


def _parse_groups(pattern: str) -> list[list[str]]:
    """Split an einops pattern side into its top-level groups of axis names."""
    return [par.split() if par else [single] for par, single in re.findall(r"\(([^)]+)\)|(\S+)", pattern)]


def infer_axis_sizes(
    pattern: str, size: Sequence[Optional[int]], known: dict[str, int]
) -> dict[str, int]:
    """Infer the unknown axis sizes of ``pattern`` from the array ``size``.

    A group with at most one unknown axis and a known total solves it as
    ``total // prod(known)``; other groups contribute only their known axes.
    """
    inferred: dict[str, int] = {}
    for axes, total in zip(_parse_groups(pattern), size):
        known_axes = [a for a in axes if a in known]
        if total is None or len(known_axes) < len(axes) - 1:
            inferred.update({a: known[a] for a in known_axes})
            continue
        known_prod = prod(known[a] for a in known_axes)
        for a in axes:
            inferred[a] = known.get(a, total // known_prod)
    return inferred


def compute_size(pattern: str, axis_sizes: dict[str, int]) -> tuple[Optional[int], ...]:
    """The array size produced by ``pattern`` (None where it is unknown)."""
    return tuple(
        None if any(a not in axis_sizes for a in axes) else prod(axis_sizes[a] for a in axes)
        for axes in _parse_groups(pattern)
    )


class Reshape:
    """Bidirectional einops reshape with optional cyclic shifts.

    ``inverse_forward(forward(x)) == x`` exactly for any input of the declared
    ``input_size``; ``equation=None`` is the identity (the shifts still apply).
    """

    def __init__(
        self,
        input_size: Sequence[Optional[int]],
        equation: Optional[str] = None,
        shifts: Optional[Sequence[int]] = None,
        dims: Optional[Sequence[int]] = None,
        **axis_sizes: int,
    ) -> None:
        self.input_size = tuple(input_size)
        self.equation = equation
        if equation is None:
            self.output_size = self.input_size
            self.axis_sizes: dict[str, int] = {}
        else:
            left, right = (s.strip() for s in equation.split("->"))
            self.axis_sizes = infer_axis_sizes(left, self.input_size, axis_sizes)
            self.output_size = compute_size(right, self.axis_sizes)
            self.equation_inv = f"{right} -> {left}"
        self.shifts = tuple(shifts) if shifts is not None else None
        if self.shifts is not None:
            self.shifts_inv = tuple(-s for s in self.shifts)
            self.dims = tuple(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shifts is not None:
            x = torch.roll(x, self.shifts, self.dims)
        if self.equation is None:
            return x
        return rearrange(x, self.equation, **self.axis_sizes)

    __call__ = forward

    def inverse_forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.equation is not None:
            x = rearrange(x, self.equation_inv, **self.axis_sizes)
        if self.shifts is not None:
            x = torch.roll(x, self.shifts_inv, self.dims)
        return x


class Matricize(Reshape):
    """Fold a volume into a batch of ``(head_dim, patch_voxels)`` matrices.

    Output shape ``(batch*heads, windows, head_dim, patch_voxels)``.

    Args:
        input_size: ``(B, *S, C)`` channels-last (the default) or ``(B, C, *S)``
            channels-first; entries may be None (e.g. the batch).
        num_heads / head_dim: one of the two; ``C = h * d``.
        grid_size / patch_size: one of the two; ``S_i = g_i * p_i``.
        shifts: optional cyclic shift (scalar or per spatial axis).
        data_format: ``"channels_last"`` or ``"channels_first"``.
    """

    def __init__(
        self,
        input_size: Sequence[Optional[int]],
        num_heads: Optional[int] = None,
        head_dim: Optional[int] = None,
        grid_size: Optional[int | Sequence[int]] = None,
        patch_size: Optional[int | Sequence[int]] = None,
        shifts: Optional[int | Sequence[int]] = None,
        data_format: str = CHANNELS_LAST,
    ) -> None:
        if (num_heads, head_dim) == (None, None):
            raise ValueError("'num_heads' or 'head_dim' must be specified.")
        if (grid_size, patch_size) == (None, None):
            raise ValueError("'grid_size' or 'patch_size' must be specified.")
        p = len(input_size) - 2
        self.data_format = data_format
        spatial = " ".join(f"(g{i} p{i})" for i in range(p))
        if data_format == CHANNELS_FIRST:
            left, spatial_axes = f"b (h d) {spatial}", tuple(range(2, 2 + p))
        elif data_format == CHANNELS_LAST:
            left, spatial_axes = f"b {spatial} (h d)", tuple(range(1, 1 + p))
        else:
            raise ValueError(f"Unknown data_format {data_format!r}.")
        grids = " ".join(f"g{i}" for i in range(p))
        patches = " ".join(f"p{i}" for i in range(p))
        equation = f"{left} -> (b h) ({grids}) d ({patches})"

        axis_sizes: dict[str, int] = {}
        if num_heads is not None:
            axis_sizes["h"] = max(num_heads, 1)
        if head_dim is not None:
            axis_sizes["d"] = max(head_dim, 1)
        for j, g in enumerate(to_ntuple(grid_size, p)):
            if g is not None:
                axis_sizes[f"g{j}"] = max(g, 1)
        for j, q in enumerate(to_ntuple(patch_size, p)):
            if q is not None:
                axis_sizes[f"p{j}"] = max(q, 1)
        dims = spatial_axes if shifts is not None else None
        if shifts is not None:
            shifts = to_ntuple(shifts, p)
        super().__init__(input_size, equation=equation, shifts=shifts, dims=dims, **axis_sizes)


class SWMatricize:
    """Shifted-window matricize: one ``Matricize`` per shift.

    The forward concatenates the per-shift folds along the leading axis; the
    inverse splits, inverts each exactly, and averages.
    """

    def __init__(
        self,
        input_size: Sequence[Optional[int]],
        num_heads: Optional[int] = None,
        head_dim: Optional[int] = None,
        grid_size: Optional[int | Sequence[int]] = None,
        patch_size: Optional[int | Sequence[int]] = None,
        shifts: Optional[Sequence[None | int | Sequence[int]]] = None,
        data_format: str = CHANNELS_LAST,
    ) -> None:
        p = len(input_size) - 2
        patch_size_t = to_ntuple(patch_size, p)
        if shifts is None:
            if patch_size_t[0] is None:
                raise ValueError("Default shifts require an explicit patch_size.")
            shifts = [None, tuple(s // 2 for s in patch_size_t)]
        self.shifted_windows = [
            Matricize(
                input_size,
                num_heads=num_heads,
                head_dim=head_dim,
                grid_size=to_ntuple(grid_size, p),
                patch_size=patch_size_t,
                shifts=s,
                data_format=data_format,
            )
            for s in shifts
        ]
        self.output_size = self.shifted_windows[0].output_size
        self.input_size = tuple(input_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([m.forward(x) for m in self.shifted_windows], dim=0)

    __call__ = forward

    def inverse_forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = torch.chunk(x, len(self.shifted_windows), dim=0)
        out = self.shifted_windows[0].inverse_forward(parts[0])
        for m, z in zip(self.shifted_windows[1:], parts[1:]):
            out = out + m.inverse_forward(z)
        return out / len(self.shifted_windows)
