"""Blind deconvolution layer: fit ``x ~ conv(s, h)`` by multiplicative updates.

PyTorch counterpart of ``factorizer_tpu/factorization/deconv.py``.  Layout is
channels-last ``(B, *spatial, C)``; filters keep the torch grouped-convolution
layout plus a batch axis, ``(B, C_out, in_per_group, *k)``, channels
group-major.  The multiplicative updates run in float32 (float64 for a
float64 input) whatever the activation dtype: ``eps = 1e-16`` does not survive
bfloat16.

One route per case: a depthwise convolution with "same" padding, which is
every convolution of the ``groups=-1, ratio=1`` bundles, goes through K3
(:func:`factorizer_tpu_torch.ops.kernels.depthwise_conv`); any other grouping
is one stock ``F.conv{1,2,3}d`` over the ``(1, B*C, *S)`` view with
``groups = B * groups``.  The JAX package's block-diagonal weight expansion
and its kernel-selection switches work around the TPU compiler and have no
counterpart here.

On slabs (``parallel.slabs.on_slabs`` sets ``Deconv.slabs``) each convolution
of the source update takes its own input's halo of ``k1 // 2`` rows from each
neighbour (zeros beyond the volume), runs as it does on a whole tensor ("same"
padding, K3 where depthwise) and keeps its slab's rows.  The crop's backward
pads the cotangent with zeros, so K3's weight gradient counts the slab's own
outputs alone, and the halo's backward hands its rows' cotangent back to the
slab they came from.  The filter update (``update_filter``) correlates over
the whole volume: each of its two ``sconv`` terms is each slab's partial
correlation (the first operand with a halo of ``k1 // 2`` rows from each
neighbour, zeros beyond the volume, and no padding along S1; the second, the
slab's own rows), summed over the slabs by ``slab_sum``, whose backward sums
the cotangent over them too; its denominator's convolution takes the same halo
and crop as the source update's.  The sum is the same on every process, so the
filter stays equal on all of them, bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.basic import _CONV, Linear, _uniform
from ..ops.kernels import depthwise_conv
from ..ops.math import relative_error
from ..parallel.collectives import halo_exchange, slab_sum
from ..utils.helpers import to_ntuple

__all__ = ["Deconv", "DeconvInit", "batched_conv", "sconv"]

Padding = Sequence[tuple[int, int]]


def _conv_padded(x: torch.Tensor, weight: torch.Tensor, padding: Padding, groups: int) -> torch.Tensor:
    """Channels-first ``F.conv*d`` with per-axis ``(lo, hi)`` zero padding."""
    if all(lo == hi for lo, hi in padding):
        pad = tuple(lo for lo, _ in padding)
    else:
        x = F.pad(x, [p for lo_hi in reversed(padding) for p in lo_hi])
        pad = 0
    return _CONV[x.ndim - 2](x, weight, None, 1, pad, 1, groups)


def _is_depthwise_same(s: torch.Tensor, h: torch.Tensor, padding: Padding, groups: int) -> bool:
    ks = h.shape[3:]
    return (
        s.ndim in (4, 5)
        and groups == s.shape[-1] == h.shape[1]
        and h.shape[2] == 1
        and all(k % 2 == 1 and lo == hi == k // 2 for (lo, hi), k in zip(padding, ks))
    )


def batched_conv(s: torch.Tensor, h: torch.Tensor, padding: Padding, groups: int = 1) -> torch.Tensor:
    """Per-sample (optionally grouped) convolution with per-sample weights.

    Args:
        s: inputs ``(B, *S, C_in)`` with ``C_in = groups * in_per_group``, channels group-major.
        h: weights ``(B, C_out, in_per_group, *k)``, ``C_out`` group-major.
        padding: per-spatial-axis ``(lo, hi)`` zero padding.
        groups: feature group count.

    Returns:
        ``(B, *S', C_out)``.
    """
    b, c_out = h.shape[:2]
    ks = tuple(h.shape[3:])
    if _is_depthwise_same(s, h, padding, groups):
        taps = h[:, :, 0].reshape(b, c_out, -1).transpose(1, 2)  # (B, taps, C), row-major over ks
        return depthwise_conv(s.contiguous(), taps, ks)
    spatial = s.shape[1:-1]
    x = s.movedim(-1, 1).reshape(1, b * s.shape[-1], *spatial)
    y = _conv_padded(x, h.reshape(b * c_out, h.shape[2], *ks), padding, b * groups)
    return y.reshape(b, c_out, *y.shape[2:]).movedim(1, -1).contiguous()


def sconv(a: torch.Tensor, b: torch.Tensor, padding: Padding) -> torch.Tensor:
    """Per-sample cross-correlation of every channel of ``a`` with every channel of ``b`` over the spatial extent.

    The filter-gradient-like term of the deconvolution updates: ``a (B, *S, Ca)``
    is the input and ``b (B, *S, Cb)`` the kernel.  Returns ``(B, Ca, Cb, *out)``
    with ``out_i = lo_i + hi_i + 1`` (where ``a`` and ``b`` have one size; a
    larger ``a``, a slab and its halo, gives that many more).
    """
    n, ca, cb = a.shape[0], a.shape[-1], b.shape[-1]
    x = a.movedim(-1, 0)  # (Ca, B, *S): the channels of a as the batch, the samples as groups
    weight = b.movedim(-1, 1).reshape(n * cb, 1, *b.shape[1:-1])
    y = _conv_padded(x, weight, padding, n)  # (Ca, B*Cb, *out)
    return y.reshape(ca, n, cb, *y.shape[2:]).movedim(0, 1)


class DeconvInit(nn.Module):
    """The nonnegative starting point: a linear head gives the source, a learnable bank ``h0`` the filter."""

    def __init__(self, channels: int, source_channels: int, groups: int, kernel_size: tuple[int, ...],
                 dtype: Optional[torch.dtype] = None, device=None, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        fan_in = source_channels * math.prod(kernel_size)  # torch's kaiming_uniform(a=sqrt(5)) bound
        self.h0 = _uniform((channels, source_channels, *kernel_size), fan_in, device, generator)
        self.linear = Linear(channels, groups * source_channels, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor, solve_dtype: Optional[torch.dtype] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """``(relu(linear(x)), relu(h0))`` in ``solve_dtype`` (None = ``x``'s), the filter broadcast over the batch."""
        dt = x.dtype if solve_dtype is None else solve_dtype
        h = self.h0.to(dt).expand(x.shape[0], *self.h0.shape)
        return torch.relu(self.linear(x).to(dt)), torch.relu(h)


class Deconv(nn.Module):
    """Blind deconvolution layer, the Deconver token mixer's core.

    From a nonnegative source ``s`` (linear head) and filter bank ``h``
    (``h0``), ``num_iters`` multiplicative updates refine ``s`` (and ``h`` with
    ``update_filter``) so that ``x ~ conv(s, h)``; the layer returns the source.
    ``groups == -1`` means depthwise.  Only the last ``num_grad_iters``
    iterations are differentiated (None = all).
    """

    def __init__(
        self,
        channels: int,
        kernel_size: int | Sequence[int] = (3, 3, 3),
        source_channels: Optional[int] = None,
        ratio: float = 4,
        groups: int = 8,
        update_source: bool = True,
        update_filter: bool = False,
        eps: float = 1e-16,
        num_iters: int = 2,
        num_grad_iters: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.channels = channels
        self.groups = channels if groups == -1 else groups
        if channels % self.groups:
            raise ValueError("`channels` must be divisible by groups")
        self.source_channels = round(channels * ratio / self.groups if source_channels is None else source_channels)
        self.kernel_size = tuple(kernel_size) if isinstance(kernel_size, Sequence) else to_ntuple(kernel_size, 3)
        self.padding = tuple((k // 2, k // 2) for k in self.kernel_size)
        self.update_source, self.update_filter = update_source, update_filter
        self.eps, self.num_iters, self.num_grad_iters = eps, num_iters, num_grad_iters
        self.init = DeconvInit(channels, self.source_channels, self.groups, self.kernel_size,
                               dtype=dtype, device=device, generator=generator)

    # This process's parallel.slabs.Slabs while the model runs on slabs, else None.
    slabs = None

    # -- group split: "b ... (g c) -> (b g) ... c", "b (g c) s ... -> (b g) c s ..." and the latter's inverse

    def _split_x(self, x: torch.Tensor) -> torch.Tensor:
        g = self.groups
        return x.reshape(*x.shape[:-1], g, -1).movedim(-2, 1).reshape(x.shape[0] * g, *x.shape[1:-1], -1)

    def _split_h(self, h: torch.Tensor) -> torch.Tensor:
        return h.reshape(h.shape[0] * self.groups, -1, *h.shape[2:])

    def _merge_h(self, h: torch.Tensor) -> torch.Tensor:
        return h.reshape(h.shape[0] // self.groups, -1, *h.shape[2:])

    # -- core math: x (B, *S, C), s (B, *S, g*sc), h (B, C, sc, *k)

    def solve_dtype(self, x: torch.Tensor) -> torch.dtype:
        return torch.promote_types(x.dtype, torch.float32)

    def initialize(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Nonnegative source and filter in ``x``'s dtype."""
        return self.init(x)

    def _initialize_solve(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(x, s, h)`` in the solve dtype; the head's output goes there without passing through ``x``'s dtype."""
        dt = self.solve_dtype(x)
        s, h = self.init(x, dt)
        return x.to(dt), s, h

    def slab_rows_missing(self, rows_in: int, rows_out: int) -> Optional[str]:
        """Why the layer cannot run on slabs of these rows, or None: its halo of ``k1 // 2`` rows must come from one
        neighbour."""
        width = self.kernel_size[0] // 2
        if width <= min(rows_in, rows_out):
            return None
        return (f"slabs: Deconv(k{self.kernel_size[0]}) takes a halo of {width} rows, wider than a slab of "
                f"{min(rows_in, rows_out)}")

    def _conv(self, s: torch.Tensor, h: torch.Tensor, groups: Optional[int] = None) -> torch.Tensor:
        """``conv(s, h)`` at the layer's padding and ``groups`` (the layer's by default: source -> signal, or with the
        adjoint filter back); on slabs, on the slab and its halo, then cropped to the slab's rows."""
        groups = self.groups if groups is None else groups
        if self.slabs is None:
            return batched_conv(s, h, self.padding, groups)
        width, rows = self.kernel_size[0] // 2, s.shape[1]
        if width:
            s = halo_exchange(s, self.slabs.mesh, self.slabs.axis, width, dim=1)
        return batched_conv(s, h, self.padding, groups).narrow(1, width, rows)

    def _sconv(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``sconv(a, b)`` over the whole volume; on slabs, each slab's partial correlation (``a`` with a halo of
        ``k1 // 2`` rows and no padding along S1, ``b`` its own rows) summed over the slabs."""
        if self.slabs is None:
            return sconv(a, b, self.padding)
        width = self.kernel_size[0] // 2
        if width:
            a = halo_exchange(a, self.slabs.mesh, self.slabs.axis, width, dim=1)
        part = sconv(a, b, ((0, 0), *self.padding[1:]))
        return slab_sum(part, self.slabs.mesh, self.slabs.axis)

    def _adjoint_h(self, h: torch.Tensor) -> torch.Tensor:
        """The adjoint filter: ``(B, C, sc, *k) -> (B, g*sc, C/g, *k)``, spatially flipped."""
        b, g, sc = h.shape[0], self.groups, self.source_channels
        ha = h.reshape(b, g, self.channels // g, sc, *self.kernel_size).transpose(2, 3)
        return ha.reshape(b, g * sc, self.channels // g, *self.kernel_size).flip(tuple(range(3, h.ndim)))

    def normalize_h(self, h: torch.Tensor) -> torch.Tensor:
        """Each group's filters scaled to sum to one per source channel."""
        hs = self._split_h(h)
        axes = tuple(d for d in range(hs.ndim) if d not in (0, 2))
        return self._merge_h((hs + self.eps) / (hs.sum(axes, keepdim=True) + self.eps))

    def update_s(self, x: torch.Tensor, s: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """The multiplicative update of the source: three convolutions and a quotient."""
        h_adj = self._adjoint_h(h)
        numerator = self._conv(x, h_adj) + self.eps
        denominator = self._conv(self._conv(s, h), h_adj) + self.eps
        return s * numerator / denominator

    def update_h(self, x: torch.Tensor, s: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """The multiplicative update of the filter, on the group-split layout."""
        xs, ss, hs = self._split_x(x), self._split_x(s), self._split_h(h)
        numerator = self._sconv(ss, xs) + self.eps
        denominator = self._sconv(ss, self._conv(ss, hs, groups=1)) + self.eps
        return self._merge_h(hs * (numerator / denominator).transpose(1, 2))

    def _update(self, x, s, h):
        if self.update_source:
            s = self.update_s(x, s, h)
        if self.update_filter:
            h = self.update_h(x, s, h)
        return s, h

    def iterative_update(self, x: torch.Tensor, s: torch.Tensor, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``num_iters`` updates; the leading ``num_iters - num_grad_iters`` see detached inputs.

        A factor that is not updated passes through those iterations with its
        autograd history intact.
        """
        num_grad = self.num_iters if self.num_grad_iters is None else self.num_grad_iters
        k = self.num_iters - num_grad
        for it in range(1, self.num_iters + 1):
            if it <= k:
                s_new, h_new = self._update(x.detach(), s.detach(), h.detach())
                s = s_new if self.update_source else s
                h = h_new if self.update_filter else h
            else:
                s, h = self._update(x, s, h)
        return s, h

    def fit(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The fitted ``(s, h)`` in ``x``'s dtype."""
        s, h = self.iterative_update(*self._initialize_solve(x))
        return s.to(x.dtype), h.to(x.dtype)

    def reconstruct(self, s: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self._conv(s, h)

    def loss(self, x: torch.Tensor, s: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """Relative reconstruction error per sample and group: a ``(B*g,)`` vector."""
        if self.groups != 1:
            x, s, h = self._split_x(x), self._split_x(s), self._split_h(h)
            return relative_error(x, batched_conv(s, h, self.padding))
        return relative_error(x, self._conv(s, h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, _ = self.iterative_update(*self._initialize_solve(x))
        return s.to(x.dtype)
