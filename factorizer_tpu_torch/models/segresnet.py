"""SegResNet: residual encoder-decoder segmentation CNN.

PyTorch counterpart of ``factorizer_tpu/models/segresnet.py`` (after
Myronenko 2018): GroupNorm + ReLU pre-activation residual blocks,
strided-conv downsampling, a decoder of k1 channel reductions, upsampling
(transposed convolutions, or linear, which the bundles use) and additive
skips.  Channels-last inside; submodules carry the Flax module names
(``stem``, ``down1``, ``enc1_0``, ``reduce0``, ``up0``, ``dec0_0``,
``final_norm``, ``head``), so the weight bridge maps them by name.

The JAX model takes its rank from the input it is initialised with, and the
bundles' ``network_def`` names none (``segresnet_fives`` is 2-D).  So this one
builds its layers at its first input, or when :meth:`SegResNet.materialize`
is called with the rank: the entry points that know ``roi_size``
(``SegmentationTrainer``, ``Evaluator``, ``evaluate_bundle``,
``ensemble_inference``, ``ensemble_predict``) call it before they move the
model, make its optimiser or load weights.  The weights are drawn then, from
the generator given at construction (with none, from one seeded by a draw
from torch's default generator at construction, so that a seed set before the
model is made fixes its weights).

On slabs (``parallel.slabs.on_slabs``, the spatial step) the layers take their
slab paths (``layers.basic``: the GroupNorms' statistics over the whole
volume, the convolutions' halos, a stride-2 one on an even row count per
slab), and the linear upsampling resizes the slab and a one-row halo whose
rows beyond the volume repeat its edge (``halo_exchange(edge="replicate")``),
then crops, which gives the whole volume's rows.  Levels whose slab holds too
few rows run gathered with every deeper one (:meth:`SegResNet.slab_route`,
``parallel.slabs.run_ladder``).  The model must be built before it runs on
slabs: layers made inside ``on_slabs`` would not be on it.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.basic import Conv, ConvTranspose, Dropout, FlaxGroupNorm, resolve_activation
from ..parallel.collectives import halo_exchange
from ..parallel.slabs import Cut, Route, run_ladder, run_whole
from ..utils.helpers import resolve_device
from .unet import first_gathered_level

__all__ = ["SegResNet", "SegResBlock"]

_LINEAR_MODES = {1: "linear", 2: "bilinear", 3: "trilinear"}


def _resize_linear(x: torch.Tensor, factor: int, slabs=None) -> torch.Tensor:
    """N-D linear upsampling of a channels-last tensor by an integer factor: ``jax.image.resize(method="linear")``
    at half-pixel centres.  With ``slabs``, ``x`` is this process's slab: it is resized with a one-row halo, edge
    rows repeated beyond the volume, and the ``factor`` rows that each halo row gives are cropped off."""
    rows = x.shape[1]
    if slabs is not None:
        x = halo_exchange(x, slabs.mesh, slabs.axis, 1, dim=1, edge="replicate")
    y = F.interpolate(x.movedim(-1, 1), scale_factor=factor, mode=_LINEAR_MODES[x.ndim - 2], align_corners=False)
    if slabs is not None:
        y = y.narrow(2, factor, rows * factor)
    return y.movedim(1, -1).contiguous()


class SegResBlock(nn.Module):
    """Pre-activation residual block: (GN -> act -> Conv3) x 2 + skip."""

    def __init__(self, channels: int, norm_groups: int = 8, act: Any = "relu", dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None, spatial_dims: int = 3) -> None:
        super().__init__()
        device = resolve_device(device)
        conv = dict(kernel_size=3, padding=1, dtype=dtype, device=device, generator=generator, spatial_dims=spatial_dims)
        self.act = resolve_activation(act)
        self.norm1 = FlaxGroupNorm(norm_groups, channels, dtype=dtype, device=device)
        self.conv1 = Conv(channels, channels, **conv)
        self.norm2 = FlaxGroupNorm(norm_groups, channels, dtype=dtype, device=device)
        self.conv2 = Conv(channels, channels, **conv)

    def slab_path_missing(self) -> Optional[str]:
        """None: its convolutions and norms have slab paths (``layers.basic``)."""
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(self.act(self.norm1(x)))
        out = self.conv2(self.act(self.norm2(out)))
        return out + x


class SegResNet(nn.Module):
    """Residual encoder-decoder with additive skips, over volumes or images (the rank of its first input).

    Args:
        init_filters: stem width (doubles per encoder level).
        blocks_down / blocks_up: residual blocks per level.
        upsample_mode: ``"deconv"`` (k2 stride-2 transposed convolutions) or ``"linear"``.
        dropout: after the stem, in training mode.
        data_format: ``"channels_first"`` takes and returns ``(B, C, *S)``; ``"channels_last"`` ``(B, *S, C)``.
    """

    # This process's parallel.slabs.Slabs while the model runs on slabs, else None.
    slabs = None

    def slab_path_missing(self) -> Optional[str]:
        """What keeps the model from the spatial step (``parallel.slabs``), or None."""
        if not self.materialized:
            return "SegResNet has not been built: utils.helpers.materialize(model, spatial_dims) before the spatial step"
        return None

    def _parts(self, level: int) -> list[str]:
        """The names of the layers at encoder level ``level``: its downsampling (or the stem) and blocks, the decoder's
        blocks at it, its reduction and upsampling to the level above, and at level 0 the final norm and head."""
        names = ["stem" if level == 0 else f"down{level}"] + [f"enc{level}_{j}" for j in range(self.blocks_down[level])]
        for i, n_blocks in enumerate(self.blocks_up):
            if len(self.blocks_down) - 2 - i == level:
                names += [f"dec{i}_{j}" for j in range(n_blocks)]
            if len(self.blocks_down) - 1 - i == level:
                names += [f"reduce{i}"] + ([f"up{i}"] if self.upsample_mode == "deconv" else [])
        return names + (["final_norm", "head"] if level == 0 else [])

    def slab_strides(self) -> list[int]:
        """Each level's stride along the cut axis: the stem's 1, then each downsampling's 2
        (``parallel.slabs.choose_cut``)."""
        return [1] + [2] * (len(self.blocks_down) - 1)

    def slab_route(self, cut: Cut) -> Route:
        """The route on the cut ``cut`` (``parallel.slabs.Cut``) of the input's rows: the
        first level with a layer that has too few rows on some slab, and every deeper level, run gathered."""
        rs = [Fraction(cut.rows)] + [Fraction(cut.rows, 2**level) for level in range(len(self.blocks_down))]
        return first_gathered_level([[(name, getattr(self, name), rs[level], rs[level + 1]) for name in self._parts(level)]
                                     for level in range(len(self.blocks_down))], cut)

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        init_filters: int = 32,
        blocks_down: Sequence[int] = (1, 2, 2, 4),
        blocks_up: Sequence[int] = (1, 1, 1),
        norm_groups: int = 8,
        act: Any = "relu",
        dropout: float = 0.0,
        upsample_mode: str = "deconv",
        data_format: str = "channels_first",
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if upsample_mode not in ("deconv", "linear"):
            raise ValueError(f"upsample_mode must be 'deconv' or 'linear', got {upsample_mode!r}")
        self.in_channels, self.out_channels, self.init_filters = in_channels, out_channels, init_filters
        self.blocks_down, self.blocks_up = tuple(blocks_down), tuple(blocks_up)
        self.norm_groups, self.upsample_mode, self.data_format = norm_groups, upsample_mode, data_format
        self.act_spec, self.act = act, resolve_activation(act)
        self.dtype, self._device = dtype, resolve_device(device)
        self.drop = Dropout(dropout)
        if generator is None:
            generator = torch.Generator().manual_seed(int(torch.randint(2**62, (1,)).item()))
        self._generator: Optional[torch.Generator] = generator
        self.spatial_dims: Optional[int] = None

    @property
    def materialized(self) -> bool:
        return self.spatial_dims is not None

    def materialize(self, spatial_dims: int) -> "SegResNet":
        """Build the layers for ``spatial_dims``-D inputs (2 or 3), drawing their weights; a second call must name the
        same rank."""
        if self.materialized:
            if spatial_dims != self.spatial_dims:
                raise ValueError(f"SegResNet was built for {self.spatial_dims}-D inputs, not {spatial_dims}-D")
            return self
        with torch.inference_mode(False):  # a first forward under inference mode must still give trainable weights
            self._build(spatial_dims)
        return self

    def _build(self, spatial_dims: int) -> None:
        gen, f = self._generator, self.init_filters
        kw = dict(dtype=self.dtype, device=self._device, generator=gen, spatial_dims=spatial_dims)
        block = dict(norm_groups=self.norm_groups, act=self.act_spec, **kw)
        self.stem = Conv(self.in_channels, f, kernel_size=3, padding=1, **kw)
        for level, n_blocks in enumerate(self.blocks_down):
            width = f * 2**level
            if level > 0:
                setattr(self, f"down{level}", Conv(width // 2, width, kernel_size=3, stride=2, padding=1, **kw))
            for j in range(n_blocks):
                setattr(self, f"enc{level}_{j}", SegResBlock(width, **block))
        for i, n_blocks in enumerate(self.blocks_up):
            level = len(self.blocks_down) - 1 - i
            width = f * 2 ** (level - 1)
            setattr(self, f"reduce{i}", Conv(2 * width, width, kernel_size=1, **kw))
            if self.upsample_mode == "deconv":
                setattr(self, f"up{i}", ConvTranspose(width, width, kernel_size=2, stride=2, **kw))
            for j in range(n_blocks):
                setattr(self, f"dec{i}_{j}", SegResBlock(width, **block))
        width = f * 2 ** (len(self.blocks_down) - 1 - len(self.blocks_up))
        self.final_norm = FlaxGroupNorm(self.norm_groups, width, dtype=self.dtype, device=self._device)
        self.head = Conv(width, self.out_channels, kernel_size=1, **kw)
        self.spatial_dims, self._generator = spatial_dims, None

    def _down(self, level: int, out: torch.Tensor) -> torch.Tensor:
        if level == 0:
            out = self.stem(out)
            if self.drop.p:
                out = self.drop(out)
        else:
            out = getattr(self, f"down{level}")(out)
        for j in range(self.blocks_down[level]):
            out = getattr(self, f"enc{level}_{j}")(out)
        return out

    def _up(self, i: int, out: torch.Tensor) -> torch.Tensor:
        out = getattr(self, f"reduce{i}")(out)
        return getattr(self, f"up{i}")(out) if self.upsample_mode == "deconv" else _resize_linear(out, 2, self.slabs)

    def _merge(self, i: int, skip: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        out = out + skip
        for j in range(self.blocks_up[i]):
            out = getattr(self, f"dec{i}_{j}")(out)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.materialized:
            self.materialize(x.ndim - 2)
        slabs, level = self.slabs, None
        dim = 2 if self.data_format == "channels_first" else 1
        if slabs is not None:
            level = self.slab_route(slabs.line_cut(x.shape[dim])).level
            if level == 0:
                return run_whole(self, x, slabs, dim)
        if self.data_format == "channels_first":
            x = x.movedim(1, -1).contiguous()
        n_levels = len(self.blocks_down)
        down = [lambda t, lv=lv: self._down(lv, t) for lv in range(n_levels)]
        up = {n_levels - 2 - i: (lambda t, i=i: self._up(i, t)) for i in range(len(self.blocks_up))}
        merge = {n_levels - 2 - i: (lambda skip, t, i=i: self._merge(i, skip, t)) for i in range(len(self.blocks_up))}
        out = run_ladder(x, down, up, merge, (), level, slabs, [self])
        out = self.head(self.act(self.final_norm(out[min(merge, default=n_levels - 1)])))
        if self.data_format == "channels_first":
            out = out.movedim(-1, 1)
        return out
