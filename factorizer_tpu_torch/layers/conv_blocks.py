"""Generic CNN blocks for U-Nets, on channels-last tensors.

PyTorch counterpart of ``factorizer_tpu/layers/conv_blocks.py``.  Slots take
the ``partialize`` idiom, ``Class | (Class, args..., kwargs)``, as the JAX
blocks do.  A Flax module takes its rank from its input; these take
``spatial_dims`` and hand it, with ``device`` and ``generator``, to each
slot's class that accepts it.  Submodules carry the Flax module names
(``conv1``, ``drop1``, ``norm1``, ..., ``shortcut``), so the weight bridge maps
them by name.
"""

from __future__ import annotations

from math import prod
from typing import Any, Optional

import torch
from torch import nn

from ..utils.helpers import as_tuple, build_spec, partialize, resolve_device
from .basic import Conv, Dropout, GroupNorm, Linear, resolve_activation

__all__ = ["DoubleConv", "BasicBlock", "PreActivationBlock", "SepConv"]

_DEFAULT_CONV = (Conv, {"kernel_size": 3, "padding": 1})
_DEFAULT_NORM = (GroupNorm, (8,))
_DEFAULT_DROP = (Dropout, {"p": 0.0})


def _spec_class(spec: Any):
    """The underlying class of a partializable spec."""
    fn = partialize(spec)
    return getattr(fn, "func", fn)


def _shortcut(conv: Any, in_channels: int, out_channels: int, stride: Any, context: dict) -> Optional[nn.Module]:
    """The k1 projection, without bias, of the conv spec's class where the stride or the width changes; else None."""
    if prod(as_tuple(stride)) == 1 and in_channels == out_channels:
        return None
    return build_spec(_spec_class(conv), in_channels, out_channels, kernel_size=1, padding=0, stride=stride, bias=False,
                  context=context)


class DoubleConv(nn.Module):
    """(Conv -> Drop -> Norm -> Act) x 2 (reference: conv.py:12-55)."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: Optional[int] = None,
                 conv: Any = _DEFAULT_CONV, norm: Any = _DEFAULT_NORM, act: Any = "leaky_relu",
                 drop: Any = _DEFAULT_DROP, stride: Any = 1, spatial_dims: int = 3, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        ctx = dict(device=resolve_device(device), generator=generator, spatial_dims=spatial_dims)
        mid = out_channels if mid_channels is None else mid_channels
        self.act = resolve_activation(act)
        self.conv1 = build_spec(conv, in_channels, mid, stride=stride, context=ctx)
        self.drop1 = build_spec(drop, context=ctx)
        self.norm1 = build_spec(norm, mid, context=ctx)
        self.conv2 = build_spec(conv, mid, out_channels, stride=1, context=ctx)
        self.drop2 = build_spec(drop, context=ctx)
        self.norm2 = build_spec(norm, out_channels, context=ctx)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.act(self.norm1(self.drop1(self.conv1(x))))
        return self.act(self.norm2(self.drop2(self.conv2(out))))


class BasicBlock(nn.Module):
    """Basic ResNet block (reference: conv.py:55-118); a k1 projection shortcut, built from the conv spec's class
    without bias, when the stride or the width changes."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: Optional[int] = None,
                 conv: Any = _DEFAULT_CONV, norm: Any = _DEFAULT_NORM, act: Any = "leaky_relu",
                 drop: Any = _DEFAULT_DROP, stride: Any = 1, spatial_dims: int = 3, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        ctx = dict(device=resolve_device(device), generator=generator, spatial_dims=spatial_dims)
        mid = out_channels if mid_channels is None else mid_channels
        self.act = resolve_activation(act)
        self.shortcut = _shortcut(conv, in_channels, out_channels, stride, ctx)
        self.conv1 = build_spec(conv, in_channels, mid, stride=stride, context=ctx)
        self.drop1 = build_spec(drop, context=ctx)
        self.norm1 = build_spec(norm, mid, context=ctx)
        self.conv2 = build_spec(conv, mid, out_channels, stride=1, context=ctx)
        self.drop2 = build_spec(drop, context=ctx)
        self.norm2 = build_spec(norm, out_channels, context=ctx)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        out = self.act(self.norm1(self.drop1(self.conv1(x))))
        out = self.norm2(self.drop2(self.conv2(out)))
        return self.act(out + shortcut)


class PreActivationBlock(nn.Module):
    """Pre-activation ResNet block (reference: conv.py:118-176).  The projection shortcut, when there is one,
    takes the normalised and activated input, as the JAX block's does."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: Optional[int] = None,
                 conv: Any = _DEFAULT_CONV, norm: Any = _DEFAULT_NORM, act: Any = "leaky_relu",
                 drop: Any = _DEFAULT_DROP, stride: Any = 1, spatial_dims: int = 3, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        ctx = dict(device=resolve_device(device), generator=generator, spatial_dims=spatial_dims)
        mid = out_channels if mid_channels is None else mid_channels
        self.act = resolve_activation(act)
        self.norm1 = build_spec(norm, in_channels, context=ctx)
        self.shortcut = _shortcut(conv, in_channels, out_channels, stride, ctx)
        self.conv1 = build_spec(conv, in_channels, mid, stride=stride, context=ctx)
        self.drop1 = build_spec(drop, context=ctx)
        self.norm2 = build_spec(norm, mid, context=ctx)
        self.conv2 = build_spec(conv, mid, out_channels, stride=1, context=ctx)
        self.drop2 = build_spec(drop, context=ctx)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.act(self.norm1(x))
        shortcut = x if self.shortcut is None else self.shortcut(out)
        out = self.drop1(self.conv1(out))
        out = self.drop2(self.conv2(self.act(self.norm2(out))))
        return out + shortcut


class SepConv(nn.Module):
    """Inverted separable convolution (MobileNetV2-style; reference: conv.py:229-282): a pointwise expansion without
    bias, the activation, a depthwise convolution, a pointwise projection."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None, hidden_channels: Optional[int] = None,
                 ratio: float = 2, act: Any = "gelu", kernel_size: int = 5, stride: Any = 1, padding: int = 2,
                 dilation: int = 1, bias: Any = True, spatial_dims: int = 3, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        out_ch = in_channels if out_channels is None else out_channels
        hidden = int(ratio * in_channels) if hidden_channels is None else hidden_channels
        self.act = resolve_activation(act)
        self.pwconv1 = Linear(in_channels, hidden, bias=False, device=device, generator=generator)
        self.dwconv = Conv(hidden, hidden, kernel_size=kernel_size, stride=stride, padding=padding, bias=bool(bias),
                           device=device, generator=generator, spatial_dims=spatial_dims, groups=hidden,
                           dilation=dilation)
        self.pwconv2 = Linear(hidden, out_ch, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pwconv2(self.dwconv(self.act(self.pwconv1(x))))
