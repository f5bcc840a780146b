"""Basic layers on channels-last tensors: Linear, Dense, the norms, MLP, Dropout, Conv, ConvTranspose.

PyTorch counterpart of ``factorizer_tpu/layers/basic.py``.  Every layer takes
``(B, *spatial, C)``.  Submodules and parameters carry the reference torch
model's names (``linear.weight``, ``norm.weight``, ``block.0`` / ``block.3``,
a conv's own ``weight``), so a state dict maps onto the JAX variables through
``factorizer_tpu.utils.torch_import.convert_state_dict``.

``dtype`` is the compute dtype (``torch.bfloat16`` under amp); parameters stay
float32 and are cast at the call, as the JAX layers do.  Weights are drawn on
the CPU from an explicit ``torch.Generator`` (torch's default scheme: uniform
in ``±1/sqrt(fan_in)`` for kernels and biases) and moved to ``device``.

``Dense``, ``FlaxLayerNorm`` and ``FlaxGroupNorm`` are flax's own
``nn.Dense``, ``nn.LayerNorm`` and ``nn.GroupNorm`` as the JAX baselines call
them bare: their parameters sit on the module itself, flax's defaults hold
(lecun-normal kernels and zero biases; LayerNorm's eps 1e-6), and the weight
bridge reads them by class.

:func:`prenorm_mlp_reason` is the one rule by which a pre-norm block's tail
``x + mlp(norm2(x))`` takes K2 (``ops.kernels.prenorm_mlp``), in the
Factorizer's and the Deconver's blocks alike; :func:`prenorm_mlp_tail` applies it.

On slabs (``parallel.slabs.on_slabs`` sets ``slabs`` on the layers that have a
slab path) the norms take their statistics over the whole volume through
``parallel.slab_sum``, a convolution exchanges a halo of its padding rows
along the cut axis and pads none there, and a transposed convolution whose
kernel equals its stride runs on its slab as it is.  ``Conv`` and
``ConvTranspose`` state the rows they need (``slab_rows_missing``), which the
models' route rules read before a forward (``parallel.slabs``).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.mlp_block import KERNEL_WIDTHS, prenorm_mlp
from ..parallel.collectives import halo_exchange, slab_sum
from ..utils.helpers import to_ntuple

__all__ = ["Identity", "Linear", "Dense", "LayerNorm", "FlaxLayerNorm", "GroupNorm", "FlaxGroupNorm", "InstanceNorm",
           "MLP", "Dropout", "Conv", "ConvTranspose", "ACTIVATIONS", "resolve_activation", "build_norm",
           "prenorm_mlp_reason", "prenorm_mlp_tail"]

ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": F.gelu,  # the exact erf form, torch's default and the JAX table's
    "leaky_relu": F.leaky_relu,  # negative slope 0.01, as jax.nn.leaky_relu
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


def resolve_activation(spec):
    """An elementwise function from a name in :data:`ACTIVATIONS`, None (identity), an elementwise callable, or a
    zero-argument factory of one (a class such as ``torch.nn.ReLU``), as the JAX ``resolve_activation`` takes them."""
    if spec is None:
        return ACTIVATIONS["identity"]
    if isinstance(spec, str):
        return ACTIVATIONS[spec]
    if not callable(spec):
        raise TypeError(f"activation must be a name, None or a callable, got {spec!r}")
    try:
        if isinstance(spec(torch.zeros(())), torch.Tensor):
            return spec
    except TypeError:
        pass
    return spec()


LN_EPS = 1e-5  # torch's LayerNorm default, as the JAX model's
FLAX_LN_EPS = 1e-6  # flax's nn.LayerNorm default, which the JAX transformers use bare

Identity = nn.Identity


def _uniform(shape: Sequence[int], fan_in: int, device, generator) -> nn.Parameter:
    """torch's default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn on the CPU."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    w = (torch.rand(tuple(shape), generator=generator) * 2 - 1) * bound
    return nn.Parameter(w.to(device))


def _lecun_normal(shape: Sequence[int], fan_in: int, device, generator) -> nn.Parameter:
    """flax's default Dense kernel: a normal truncated at two deviations, scaled to variance 1 / fan_in."""
    # 0.8796... is the deviation of a unit normal truncated to [-2, 2]
    return truncated_normal(shape, math.sqrt(1.0 / fan_in) / 0.87962566103423978, device, generator)


def truncated_normal(shape: Sequence[int], std: float, device, generator) -> nn.Parameter:
    """flax's ``truncated_normal(std)``: a normal of deviation ``std`` truncated at two deviations."""
    w = nn.init.trunc_normal_(torch.empty(tuple(shape)), 0.0, std, -2 * std, 2 * std, generator=generator)
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


class Dense(nn.Module):
    """flax's ``nn.Dense`` over the trailing axis: ``weight (out, in)`` (the Flax ``kernel``, transposed) and ``bias``
    on the module itself, drawn as flax draws them (lecun-normal kernel, zero bias)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = _lecun_normal((out_features, in_features), in_features, device, generator)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm, eps: float, dtype: Optional[torch.dtype]) -> torch.Tensor:
    dt = _compute_dtype(dtype, x, norm.weight)
    stat = torch.promote_types(x.dtype, torch.float32)  # float64 stays float64, for semantic checks
    y = F.layer_norm(x.to(stat), norm.normalized_shape, norm.weight.to(stat), norm.bias.to(stat), eps)
    return y.to(dt)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing axis (eps 1e-5 by default); statistics in float32, output in ``dtype``."""

    def __init__(self, dim: int, eps: float = LN_EPS, dtype: Optional[torch.dtype] = None, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.norm = nn.LayerNorm(dim, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm(x, self.norm, self.eps, self.dtype)


class FlaxLayerNorm(nn.LayerNorm):
    """flax's bare ``nn.LayerNorm`` (eps 1e-6): ``weight`` / ``bias`` are the Flax ``scale`` / ``bias`` of this
    module; statistics in float32, output in ``dtype``."""

    def __init__(self, dim: int, eps: float = FLAX_LN_EPS, dtype: Optional[torch.dtype] = None, device=None) -> None:
        super().__init__(dim, eps=eps, device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _layer_norm(x, self, self.eps, self.dtype)


def _group_norm(x: torch.Tensor, groups: int, weight, bias, eps: float, dtype, slabs=None) -> torch.Tensor:
    """Normalise ``x (B, *S, C)`` over the spatial axes and the channels of each of ``groups`` groups.

    Reduces over the channels-last tensor directly (no transposes); statistics
    and arithmetic in float32 (float64 stays float64), output in ``dtype``.
    With ``slabs`` (a ``parallel.slabs.Slabs``), ``x`` is this process's slab
    (of equal rows or not) and the statistics are the whole volume's, over its
    whole count of voxels: the slabs' sums
    through :func:`~..parallel.collectives.slab_sum`, the mean first and then
    the centred sum of squares, as the one-process form centres before it squares.
    """
    stat = torch.promote_types(x.dtype, torch.float32)
    b, c = x.shape[0], x.shape[-1]
    xg = x.to(stat).reshape(b, -1, groups, c // groups)
    if slabs is None:
        var, mean = torch.var_mean(xg, dim=(1, 3), correction=0, keepdim=True)
        centred = xg - mean
    else:
        count = xg.shape[1] // x.shape[1] * slabs.whole_rows(x.shape[1]) * xg.shape[3]
        mean = slab_sum(xg.sum((1, 3), keepdim=True), slabs.mesh, slabs.axis) / count
        centred = xg - mean
        var = slab_sum(centred.square().sum((1, 3), keepdim=True), slabs.mesh, slabs.axis) / count
    y = (centred * torch.rsqrt(var + eps)).reshape(x.shape)
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

    # This process's parallel.slabs.Slabs while the model runs on slabs, else None.
    slabs = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.norm.weight)
        return _group_norm(x, self.num_groups, self.norm.weight, self.norm.bias, self.eps, dt, self.slabs)


class FlaxGroupNorm(nn.GroupNorm):
    """flax's bare ``nn.GroupNorm`` on channels-last tensors: ``weight`` / ``bias`` are the Flax ``scale`` / ``bias``
    of this module; statistics in float32, output in ``dtype``."""

    def __init__(self, num_groups: int, dim: int, eps: float = LN_EPS, dtype: Optional[torch.dtype] = None,
                 device=None) -> None:
        super().__init__(num_groups, dim, eps=eps, device=device)
        self.dtype = dtype

    slabs = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        return _group_norm(x, self.num_groups, self.weight, self.bias, self.eps, dt, self.slabs)


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

    slabs = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm.weight is not None:
            dt = _compute_dtype(self.dtype, x, self.norm.weight)
        else:
            dt = self.dtype if self.dtype is not None else x.dtype
        return _group_norm(x, self.dim, self.norm.weight, self.norm.bias, self.eps, dt, self.slabs)


# A norm spec: a class taking ``(channels, dtype=, device=)``, or ``(class, keyword arguments)``.
NormSpec = Any


def build_norm(spec: NormSpec, channels: int, dtype: Optional[torch.dtype], device) -> nn.Module:
    """A norm from its spec, as the bundles' ``norm`` key gives it."""
    cls, kwargs = spec if isinstance(spec, tuple) else (spec, {})
    return cls(channels, **{"dtype": dtype, "device": device, **kwargs})


class MLP(nn.Module):
    """Token-wise feed-forward ``in -> hidden -> out``: ``block`` = Linear, GELU (erf), Dropout, Linear, Dropout.

    ``hidden_channels`` defaults to ``int(ratio * in_channels)`` and
    ``out_channels`` to ``in_channels``; ``dropout`` is one rate for both
    sites or a pair, and ``bias=False`` drops both linears' biases, as the JAX
    ``MLP`` takes them.  fc1 and fc2 sit at ``block.0`` and ``block.3``, the
    reference model's places.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        hidden_channels: Optional[int] = None,
        ratio: float = 3.0,
        dropout: float | Sequence[float] = 0.0,
        bias: bool = True,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels or in_channels
        self.hidden_channels = hidden_channels or int(ratio * in_channels)
        self.dropout = to_ntuple(dropout, 2)
        kw = dict(bias=bias, dtype=dtype, device=device, generator=generator)
        self.block = nn.Sequential(
            Linear(in_channels, self.hidden_channels, **kw),
            nn.GELU(),
            Dropout(self.dropout[0]),
            Linear(self.hidden_channels, self.out_channels, **kw),
            Dropout(self.dropout[1]),
        )

    @property
    def fc1(self) -> Linear:
        return self.block[0]

    @property
    def fc2(self) -> Linear:
        return self.block[3]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


def prenorm_mlp_reason(norm2: nn.Module, mlp: nn.Module) -> Optional[str]:
    """Why a block's tail ``x + mlp(norm2(x))`` does not take K2 (``ops.kernels.prenorm_mlp``); None when it does.

    The JAX package's ``_fused_prenorm_mlp_reason`` without its TPU and
    environment checks, decided by the configuration alone: a
    :class:`LayerNorm`, a shape-preserving :class:`MLP`, no active dropout
    (the module in training mode with a rate above 0 at either site), a width
    in ``KERNEL_WIDTHS`` and a hidden width that 32 divides.  Both block
    families route by it; a tail that it sends to K2 launches K2 for a CUDA
    tensor or raises.
    """
    if not isinstance(norm2, LayerNorm):
        return f"norm is {type(norm2).__name__}, K2 covers LayerNorm only"
    if not isinstance(mlp, MLP):
        return f"mlp is {type(mlp).__name__}"
    if mlp.out_channels != mlp.in_channels:
        return "the MLP is not shape-preserving (no residual form)"
    if mlp.training and any(mlp.dropout):
        return "active dropout (training with dropout > 0)"
    if mlp.in_channels not in KERNEL_WIDTHS:
        return f"C={mlp.in_channels} is not one of K2's widths {KERNEL_WIDTHS}"
    if mlp.hidden_channels % 32:
        return f"hidden width {mlp.hidden_channels} is not a multiple of 32"
    return None


def prenorm_mlp_tail(norm2: nn.Module, mlp: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x + mlp(norm2(x))``: through K2 where :func:`prenorm_mlp_reason` allows it, else the modules' own calls.

    A bias-free MLP hands K2 zero biases, as the JAX package does; no gradient is kept for them.
    """
    if prenorm_mlp_reason(norm2, mlp) is not None:
        return x + mlp(norm2(x))
    ln, fc1, fc2 = norm2.norm, mlp.fc1.linear, mlp.fc2.linear
    b1 = fc1.bias if fc1.bias is not None else fc1.weight.new_zeros(fc1.weight.shape[0])
    b2 = fc2.bias if fc2.bias is not None else fc2.weight.new_zeros(fc2.weight.shape[0])
    return prenorm_mlp(x, ln.weight, ln.bias, fc1.weight, b1, fc2.weight, b2, norm2.eps)


class Dropout(nn.Dropout):
    """Dropout with torch's ``p`` (0 by default, as the JAX layer); the identity in eval mode."""

    def __init__(self, p: float = 0.0) -> None:
        super().__init__(p)


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
        groups: int = 1,
        dilation: int | Sequence[int] = 1,
    ) -> None:
        super().__init__()
        ks = to_ntuple(kernel_size, spatial_dims)
        self.spatial_dims = spatial_dims
        self.stride = to_ntuple(stride, spatial_dims)
        self.padding = to_ntuple(padding, spatial_dims)
        self.dilation = to_ntuple(dilation, spatial_dims)
        self.groups = groups
        self.pointwise = set(ks) == {1} and set(self.stride) == {1} and set(self.padding) == {0} and groups == 1
        self.dtype = dtype
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"{in_channels} -> {out_channels} channels do not split into {groups} groups")
        fan_in = in_channels // groups * math.prod(ks)
        self.weight = _uniform((out_channels, in_channels // groups, *ks), fan_in, device, generator)
        self.bias = _uniform((out_channels,), fan_in, device, generator) if bias else None

    # This process's parallel.slabs.Slabs while the model runs on slabs, else None.
    slabs = None

    def slab_rows_missing(self, rows_in: int, rows_out: int) -> Optional[str]:
        """Why the convolution cannot run on slabs of ``rows_in`` input rows (``rows_out`` at the part's output), or None.

        The slabs' outputs join into the whole volume's where every slab's
        output starts on a multiple of the stride (a row count the stride
        divides) and holds ``rows / stride`` rows ("same" padding at stride 1,
        k3 p1 at stride 2, or a kernel equal to the stride), and where the halo
        of ``padding`` rows is no wider than the slab.  A stride-1 convolution
        of a part is held to the fewer of the two row counts.
        """
        if self.pointwise:
            return None
        k, s, p, d = self.weight.shape[2], self.stride[0], self.padding[0], self.dilation[0]
        rows = rows_in if s > 1 else min(rows_in, rows_out)
        if rows >= 1 and rows % s == 0 and (rows + 2 * p - d * (k - 1) - 1) // s + 1 == rows // s and p <= rows:
            return None
        layer = f"Conv({self.weight.shape[1] * self.groups} -> {self.weight.shape[0]}, k{k} s{s} p{p})"
        return (f"slabs: {layer} along the cut axis needs slabs of a row count that {s} divides, an output of rows / "
                f"{s} rows and at least {max(p, 1)} rows, got {rows} rows")

    def _on_slab(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple]:
        """This slab with a halo of ``padding[0]`` rows and the padding for the call: none along the cut axis; raises
        where :meth:`slab_rows_missing` names a reason (the models' route rules keep such a slab from it)."""
        rows = x.shape[1]
        reason = self.slab_rows_missing(rows, rows // self.stride[0])
        if reason is not None:
            raise ValueError(reason)
        p = self.padding[0]
        if p:
            x = halo_exchange(x, self.slabs.mesh, self.slabs.axis, p, dim=1)
        return x, (0, *self.padding[1:])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        if self.pointwise:
            # A k1 convolution is a linear over the channel axis: one GEMM on the channels-last tensor,
            # no layout transposes, and a GEMM for the weight gradient.
            return F.linear(x.to(dt), self.weight.to(dt).flatten(1), b)
        padding = self.padding
        if self.slabs is not None:
            x, padding = self._on_slab(x)
        y = _CONV[self.spatial_dims](_to_channels_first(x.to(dt)), self.weight.to(dt), b, self.stride, padding,
                                     self.dilation, self.groups)
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

    # This process's parallel.slabs.Slabs while the model runs on slabs, else None: each input row then gives its
    # own ``stride`` output rows, which needs a kernel equal to the stride along the cut axis.
    slabs = None

    def slab_rows_missing(self, rows_in: int, rows_out: int) -> Optional[str]:
        """Why the transposed convolution cannot run on slabs, or None: only a kernel equal to the stride along the cut
        axis runs on a slab as it is."""
        if self.weight.shape[2] == self.stride[0]:
            return None
        return (f"slabs: ConvTranspose(k{self.weight.shape[2]} s{self.stride[0]}) along the cut axis: only a kernel "
                "equal to the stride runs on a slab as it is")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.slabs is not None:
            reason = self.slab_rows_missing(x.shape[1], x.shape[1])
            if reason is not None:
                raise ValueError(reason)
        dt = _compute_dtype(self.dtype, x, self.weight)
        b = None if self.bias is None else self.bias.to(dt)
        y = _CONV_TRANSPOSE[self.spatial_dims](_to_channels_first(x.to(dt)), self.weight.to(dt), b, self.stride)
        return _to_channels_last(y)
