"""Basic layers on channels-last tensors: Linear, LayerNorm, MLP, Conv, ConvTranspose.

PyTorch counterpart of ``factorizer_tpu/layers/basic.py``.  Every layer takes
``(B, *spatial, C)``.  Submodules and parameters carry the reference torch
model's names (``linear.weight``, ``norm.weight``, ``block.0`` / ``block.3``,
a conv's own ``weight``), so a state dict maps onto the JAX variables through
``factorizer_tpu.utils.torch_import.convert_state_dict``.

``dtype`` is the compute dtype (``torch.bfloat16`` under amp); parameters stay
float32 and are cast at the call, as the JAX layers do.  Weights are drawn on
the CPU from an explicit ``torch.Generator`` (torch's default scheme: uniform
in ``±1/sqrt(fan_in)`` for kernels and biases) and moved to ``device``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.helpers import to_ntuple

__all__ = ["Identity", "Linear", "LayerNorm", "MLP", "Conv", "ConvTranspose", "ACTIVATIONS"]

ACTIVATIONS = {"relu": torch.relu}

LN_EPS = 1e-5  # torch's LayerNorm default, as the JAX model's

Identity = nn.Identity


def _uniform(shape: Sequence[int], fan_in: int, device, generator) -> nn.Parameter:
    """torch's default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn on the CPU."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    w = (torch.rand(tuple(shape), generator=generator) * 2 - 1) * bound
    return nn.Parameter(w.to(device))


def _compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


def _to_channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _to_channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1).contiguous()


class Linear(nn.Module):
    """Pointwise linear over the trailing (channel) axis; parameters under ``linear``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        bias: bool = True,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        # On ``meta`` nn.Linear draws nothing; its parameters are replaced below.
        self.linear = nn.Linear(in_channels, out_channels, bias=bool(bias), device="meta")
        self.linear.weight = _uniform((out_channels, in_channels), in_channels, device, generator)
        if bias:
            self.linear.bias = _uniform((out_channels,), in_channels, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.linear.weight, self.linear.bias
        dt = _compute_dtype(self.dtype, x, w)
        return F.linear(x.to(dt), w.to(dt), None if b is None else b.to(dt))


class LayerNorm(nn.Module):
    """LayerNorm over the trailing axis (eps 1e-5); statistics in float32, output in ``dtype``."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.eps = LN_EPS
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.norm.weight)
        y = F.layer_norm(x.float(), self.norm.normalized_shape, self.norm.weight, self.norm.bias, self.eps)
        return y.to(dt)


class MLP(nn.Module):
    """Token-wise feed-forward ``C -> ratio*C -> C``: ``block`` = Linear, GELU (erf), -, Linear, -.

    Slots 2 and 4 hold the reference model's dropouts; dropout is not ported
    (serving runs without it), and the slots keep fc2 at ``block.3``.
    """

    def __init__(
        self,
        channels: int,
        ratio: float = 3.0,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        hidden = int(ratio * channels)
        self.block = nn.Sequential(
            Linear(channels, hidden, dtype=dtype, device=device, generator=generator),
            nn.GELU(),
            nn.Identity(),
            Linear(hidden, channels, dtype=dtype, device=device, generator=generator),
            nn.Identity(),
        )

    @property
    def fc1(self) -> Linear:
        return self.block[0]

    @property
    def fc2(self) -> Linear:
        return self.block[3]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Conv(nn.Module):
    """3-D convolution on channels-last tensors (cuDNN on the card), torch-like signature."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int | Sequence[int] = 3,
        stride: int | Sequence[int] = 1,
        padding: int | Sequence[int] = 0,
        bias: bool = True,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        ks = to_ntuple(kernel_size, 3)
        self.stride = to_ntuple(stride, 3)
        self.padding = to_ntuple(padding, 3)
        self.dtype = dtype
        fan_in = in_channels * math.prod(ks)
        self.weight = _uniform((out_channels, in_channels, *ks), fan_in, device, generator)
        self.bias = _uniform((out_channels,), fan_in, device, generator) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv3d(_to_channels_first(x.to(dt)), self.weight.to(dt), b, self.stride, self.padding)
        return _to_channels_last(y)


class ConvTranspose(nn.Module):
    """3-D transposed convolution on channels-last tensors; weight ``(I, O, *k)`` as torch's."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int | Sequence[int] = 2,
        stride: int | Sequence[int] = 2,
        bias: bool = True,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        ks = to_ntuple(kernel_size, 3)
        self.stride = to_ntuple(stride, 3)
        self.dtype = dtype
        fan_in = in_channels * math.prod(ks)
        self.weight = _uniform((in_channels, out_channels, *ks), fan_in, device, generator)
        self.bias = _uniform((out_channels,), fan_in, device, generator) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv_transpose3d(_to_channels_first(x.to(dt)), self.weight.to(dt), b, self.stride)
        return _to_channels_last(y)
