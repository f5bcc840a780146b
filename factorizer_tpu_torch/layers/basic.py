"""Basic layers on channels-last tensors: Linear, the norms, MLP, Conv, ConvTranspose.

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
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.helpers import to_ntuple

__all__ = ["Identity", "Linear", "LayerNorm", "GroupNorm", "InstanceNorm", "MLP", "Conv", "ConvTranspose",
           "ACTIVATIONS", "resolve_activation", "build_norm"]

ACTIVATIONS = {"relu": torch.relu, "identity": lambda x: x}  # the names the ported bundles use


def resolve_activation(spec):
    """An elementwise function from a name in :data:`ACTIVATIONS`, None (identity) or a callable."""
    if spec is None:
        return ACTIVATIONS["identity"]
    if isinstance(spec, str):
        return ACTIVATIONS[spec]
    if not callable(spec):
        raise TypeError(f"activation must be a name, None or a callable, got {spec!r}")
    return spec

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
        stat = torch.promote_types(x.dtype, torch.float32)  # float64 stays float64, for semantic checks
        y = F.layer_norm(x.to(stat), self.norm.normalized_shape, self.norm.weight.to(stat), self.norm.bias.to(stat), self.eps)
        return y.to(dt)


def _group_norm(x: torch.Tensor, groups: int, weight, bias, eps: float, dtype) -> torch.Tensor:
    """Normalise ``x (B, *S, C)`` over the spatial axes and the channels of each of ``groups`` groups.

    Reduces over the channels-last tensor directly (no transposes); statistics
    and arithmetic in float32 (float64 stays float64), output in ``dtype``.
    """
    stat = torch.promote_types(x.dtype, torch.float32)
    b, c = x.shape[0], x.shape[-1]
    xg = x.to(stat).reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    if weight is not None:
        y = y * weight.to(stat) + bias.to(stat)
    return y.to(dtype)


class _Affine(nn.Module):
    """Holder of a norm's ``weight`` and ``bias`` (ones and zeros), or of nothing."""

    def __init__(self, dim: int, affine: bool, device=None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device)) if affine else None
        self.bias = nn.Parameter(torch.zeros(dim, device=device)) if affine else None


class GroupNorm(nn.Module):
    """Group normalisation of channels-last tensors (eps 1e-5), torch's ``(num_groups, num_channels)`` signature."""

    def __init__(self, num_groups: int, dim: int, eps: float = LN_EPS, dtype: Optional[torch.dtype] = None,
                 device=None) -> None:
        super().__init__()
        if dim % num_groups:
            raise ValueError(f"{dim} channels do not split into {num_groups} groups")
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.norm = _Affine(dim, True, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.norm.weight)
        return _group_norm(x, self.num_groups, self.norm.weight, self.norm.bias, self.eps, dt)


class InstanceNorm(nn.Module):
    """Instance normalisation: each channel of each sample over its spatial extent (eps 1e-5).

    ``affine=False``, torch's default for ``InstanceNormNd``, holds no
    parameters and so adds nothing to a state dict.  Statistics in float32
    under a bfloat16 ``dtype``, which is the output's.
    """

    def __init__(self, dim: int, eps: float = LN_EPS, affine: bool = False, dtype: Optional[torch.dtype] = None,
                 device=None) -> None:
        super().__init__()
        self.dim, self.eps, self.dtype = dim, eps, dtype
        self.norm = _Affine(dim, affine, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm.weight is not None:
            dt = _compute_dtype(self.dtype, x, self.norm.weight)
        else:
            dt = self.dtype if self.dtype is not None else x.dtype
        return _group_norm(x, self.dim, self.norm.weight, self.norm.bias, self.eps, dt)


# A norm spec: a class taking ``(channels, dtype=, device=)``, or ``(class, keyword arguments)``.
NormSpec = Any


def build_norm(spec: NormSpec, channels: int, dtype: Optional[torch.dtype], device) -> nn.Module:
    """A norm from its spec, as the bundles' ``norm`` key gives it."""
    cls, kwargs = spec if isinstance(spec, tuple) else (spec, {})
    return cls(channels, **{"dtype": dtype, "device": device, **kwargs})


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


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_TRANSPOSE = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


class Conv(nn.Module):
    """``spatial_dims``-D convolution on channels-last tensors (cuDNN on the card), torch-like signature."""

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
        spatial_dims: int = 3,
    ) -> None:
        super().__init__()
        ks = to_ntuple(kernel_size, spatial_dims)
        self.spatial_dims = spatial_dims
        self.stride = to_ntuple(stride, spatial_dims)
        self.padding = to_ntuple(padding, spatial_dims)
        self.pointwise = set(ks) == {1} and set(self.stride) == {1} and set(self.padding) == {0}
        self.dtype = dtype
        fan_in = in_channels * math.prod(ks)
        self.weight = _uniform((out_channels, in_channels, *ks), fan_in, device, generator)
        self.bias = _uniform((out_channels,), fan_in, device, generator) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        if self.pointwise:
            # A k1 convolution is a linear over the channel axis: one GEMM on the channels-last tensor,
            # no layout transposes, and a GEMM for the weight gradient.
            return F.linear(x.to(dt), self.weight.to(dt).flatten(1), b)
        y = _CONV[self.spatial_dims](_to_channels_first(x.to(dt)), self.weight.to(dt), b, self.stride, self.padding)
        return _to_channels_last(y)


class ConvTranspose(nn.Module):
    """``spatial_dims``-D transposed convolution on channels-last tensors; weight ``(I, O, *k)`` as torch's."""

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
        spatial_dims: int = 3,
    ) -> None:
        super().__init__()
        ks = to_ntuple(kernel_size, spatial_dims)
        self.spatial_dims = spatial_dims
        self.stride = to_ntuple(stride, spatial_dims)
        self.dtype = dtype
        fan_in = in_channels * math.prod(ks)
        self.weight = _uniform((in_channels, out_channels, *ks), fan_in, device, generator)
        self.bias = _uniform((out_channels,), fan_in, device, generator) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        y = _CONV_TRANSPOSE[self.spatial_dims](_to_channels_first(x.to(dt)), self.weight.to(dt), b, self.stride)
        return _to_channels_last(y)
