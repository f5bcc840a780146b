"""DynUNet: an nnU-Net-style dynamic U-Net.

PyTorch counterpart of ``factorizer_tpu/models/dynunet.py`` (after Isensee et
al.): (Conv -> InstanceNorm -> LeakyReLU) x 2 blocks, strided-conv
downsampling, transposed-conv upsampling with concatenated skips, and
optional deep-supervision heads on the decoder pyramid.  Channels-last
inside; submodules carry the Flax module names (``enc{i}``, ``up{i}``,
``dec{i}``, ``head``, ``supr{j}``), so the weight bridge maps them by name.

On slabs (``parallel.slabs.on_slabs``, the spatial step) every layer takes
its slab path (``layers.basic``): the convolutions a halo of ``k // 2`` rows,
the InstanceNorms the whole volume's statistics; the transposed convolutions
(kernel = stride) and the k1 heads, deep supervision's too, are local to the
slab.  Levels whose slab holds too few rows (a stride that does not divide
them, less than one row, a halo wider than the slab) run gathered with every
deeper one and their heads (:meth:`DynUNet.slab_route`,
``parallel.slabs.run_ladder``); a head whose level the cut does not keep
whole on every slab returns its whole output on every process
(``parallel.slabs.whole_on_slabs``).  More slabs than rows: the whole model
gathered.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..layers.basic import Conv, ConvTranspose, InstanceNorm, resolve_activation
from ..parallel.slabs import Cut, Route, run_ladder, run_whole
from ..utils.helpers import resolve_device, to_ntuple
from .unet import first_gathered_level

__all__ = ["DynUNet", "DynUNetBlock"]


class DynUNetBlock(nn.Module):
    """(Conv -> InstanceNorm -> act) x 2; the first convolution may stride.  ``kernel_size`` and ``stride`` are ints
    or one entry per axis; the padding is ``k // 2`` per axis."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int | Sequence[int] = 3,
                 stride: int | Sequence[int] = 1, act: Any = "leaky_relu", dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None, spatial_dims: int = 3) -> None:
        super().__init__()
        device = resolve_device(device)
        ks = to_ntuple(kernel_size, spatial_dims)
        conv = dict(kernel_size=ks, padding=tuple(k // 2 for k in ks), dtype=dtype, device=device, generator=generator,
                    spatial_dims=spatial_dims)
        self.act = resolve_activation(act)
        self.conv1 = Conv(in_channels, out_channels, stride=stride, **conv)
        self.norm1 = InstanceNorm(out_channels, affine=True, dtype=dtype, device=device)
        self.conv2 = Conv(out_channels, out_channels, stride=1, **conv)
        self.norm2 = InstanceNorm(out_channels, affine=True, dtype=dtype, device=device)

    def slab_path_missing(self) -> Optional[str]:
        """None: its convolutions and norms have slab paths (``layers.basic``)."""
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.act(self.norm1(self.conv1(x)))
        return self.act(self.norm2(self.conv2(out)))


class DynUNet(nn.Module):
    """nnU-Net-style U-Net with per-stage kernels and strides, and deep supervision.

    Args:
        kernel_size / strides: one entry per encoder stage, each an int or one
            entry per axis (the stride of stage 0 applies to the first block).
        filters: per-stage widths; by default ``min(32 * 2**i, 320)``.
        deep_supervision: in training mode, return ``[head, supr0, ...]``, the
            extra heads on the ``deep_supr_num`` next coarser decoder outputs;
            in eval mode the head alone.
        data_format: ``"channels_first"`` takes and returns ``(B, C, *S)``.
    """

    # This process's parallel.slabs.Slabs while the model runs on slabs, else None.
    slabs = None

    def slab_path_missing(self) -> Optional[str]:
        """What keeps the model from the spatial step (``parallel.slabs``): nothing, its layers have slab paths."""
        return None

    def slab_strides(self) -> list[int]:
        """Each encoder stage's stride along the cut axis (``parallel.slabs.choose_cut``)."""
        return list(self.strides)

    def slab_route(self, cut: Cut) -> Route:
        """The route on the cut ``cut`` (``parallel.slabs.Cut``) of the input's rows: the
        first level whose block, upsampling (from it), decoder block (at it) or head has too few rows on some slab, and
        every deeper level, run gathered."""
        rs = [Fraction(cut.rows)]
        for i in range(self.n):
            rs.append(rs[-1] / self.strides[i])
        levels = []
        for i in range(self.n):
            names = [f"enc{i}", f"up{i}" if i else "head", f"dec{i + 1}" if i < self.n - 1 else None]
            if self.deep_supervision and 1 <= i <= self.deep_supr_num:
                names.append(f"supr{i - 1}")
            levels.append([(name, getattr(self, name), rs[i], rs[i + 1]) for name in names if name])
        return first_gathered_level(levels, cut)

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        spatial_dims: int = 3,
        kernel_size: Sequence[Any] = (3, 3, 3, 3, 3),
        strides: Sequence[Any] = (1, 2, 2, 2, 2),
        filters: Optional[Sequence[int]] = None,
        deep_supervision: bool = False,
        deep_supr_num: int = 1,
        act: Any = "leaky_relu",
        data_format: str = "channels_first",
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        n = len(strides)
        filters = list(filters) if filters is not None else [min(32 * 2**i, 320) for i in range(n)]
        if deep_supervision and not 1 <= deep_supr_num <= n - 2:
            raise ValueError(f"deep_supr_num {deep_supr_num} needs 1 to {n - 2} coarser decoder outputs")
        self.n, self.data_format, self.deep_supervision, self.deep_supr_num = n, data_format, deep_supervision, deep_supr_num
        self.strides = [to_ntuple(s, spatial_dims)[0] for s in strides]
        kw = dict(dtype=dtype, device=device, generator=generator, spatial_dims=spatial_dims)
        widths_in = [in_channels] + filters[:-1]
        for i in range(n):
            setattr(self, f"enc{i}", DynUNetBlock(widths_in[i], filters[i], kernel_size[i], strides[i], act=act, **kw))
        for i in range(n - 1, 0, -1):
            setattr(self, f"up{i}", ConvTranspose(filters[i], filters[i - 1], kernel_size=strides[i], stride=strides[i],
                                                  **kw))
            setattr(self, f"dec{i}", DynUNetBlock(2 * filters[i - 1], filters[i - 1], kernel_size[i - 1], 1, act=act,
                                                  **kw))
        self.head = Conv(filters[0], out_channels, kernel_size=1, **kw)
        if deep_supervision:
            for j in range(deep_supr_num):
                setattr(self, f"supr{j}", Conv(filters[j + 1], out_channels, kernel_size=1, **kw))

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        return y.movedim(-1, 1) if self.data_format == "channels_first" else y

    def forward(self, x: torch.Tensor):
        slabs, level = self.slabs, None
        dim = 2 if self.data_format == "channels_first" else 1
        if slabs is not None:
            level = self.slab_route(slabs.line_cut(x.shape[dim])).level
            if level == 0:
                return run_whole(self, x, slabs, dim)
        if self.data_format == "channels_first":
            x = x.movedim(1, -1).contiguous()
        down = [getattr(self, f"enc{i}") for i in range(self.n)]
        up = {i - 1: getattr(self, f"up{i}") for i in range(1, self.n)}
        merge = {i - 1: (lambda skip, u, i=i: getattr(self, f"dec{i}")(torch.cat([skip, u], dim=-1)))
                 for i in range(1, self.n)}
        supr = self.deep_supervision and self.training
        names = ["head"] + ([f"supr{j}" for j in range(self.deep_supr_num)] if supr else [])
        heads = {lv: (lambda y, name=name: self._out(getattr(self, name)(y))) for lv, name in enumerate(names)}
        outs = run_ladder(x, down, up, merge, (), level, slabs, [self], heads, dim)
        return [outs[lv] for lv in range(len(names))] if supr else outs[0]
