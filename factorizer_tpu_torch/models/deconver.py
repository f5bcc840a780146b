"""Deconver models: blind-deconvolution mixing blocks in a U-Net.

PyTorch counterpart of ``factorizer_tpu/models/deconver.py`` (DeconvMixer ->
DeconverBlock -> DeconverStage -> Deconver), channels-last inside, for 3-D
volumes and 2-D images.  Submodules carry the reference torch model's names
(``dcm.in_proj``, ``dcm.deconv.init.h0``, ``dcm.deconv.init.linear``,
``dcm.out_proj``), so a state dict maps onto the JAX variables.

* ``DeconvMixer`` runs :class:`~factorizer_tpu_torch.factorization.deconv.Deconv`,
  whose convolutions go through K3 (``ops.kernels.depthwise_conv``) when they are
  depthwise, as in the ``groups=-1, ratio=1`` bundles.
* ``DeconverBlock`` sends its tail ``x + mlp(norm2(x))`` through K2
  (``ops.kernels.prenorm_mlp``) when ``norm`` is :class:`LayerNorm`; with any
  other norm (the bundles use :class:`InstanceNorm`) the tail is stock PyTorch.

``remat=True`` recomputes each stage's activations in the backward
(:class:`~factorizer_tpu_torch.models.unet.UNet`).  Dropout, deep supervision
and the ``stem`` / ``downsample`` / ``upsample`` / ``head`` overrides of the
JAX model are not ported; no bundle sets them.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..factorization.deconv import Deconv
from ..layers.basic import Conv, LayerNorm, Linear, MLP, NormSpec, build_norm, resolve_activation
from ..ops.kernels import prenorm_mlp
from .unet import UNet

__all__ = ["DeconvMixer", "DeconverBlock", "DeconverStage", "Stem", "Deconver"]

class DeconvMixer(nn.Module):
    """Token mixing: project -> act -> deconvolve -> project.  ``deconv_kwargs`` go to :class:`Deconv`."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        act: Any = "relu",
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
        **deconv_kwargs: Any,
    ) -> None:
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.in_proj = Linear(in_channels, out_channels, bias=False, **kw)
        self.act = resolve_activation(act)
        self.deconv = Deconv(out_channels, **deconv_kwargs, **kw)
        self.out_proj = Linear(self.deconv.groups * self.deconv.source_channels, out_channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(self.deconv(self.act(self.in_proj(x))))


class DeconverBlock(nn.Module):
    """Pre-norm residual block: ``x + dcm(norm1(x))``, then ``x + mlp(norm2(x))`` (K2 under LayerNorm)."""

    def __init__(
        self,
        channels: int,
        norm: NormSpec = LayerNorm,
        mlp_ratio: float = 4,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
        **mixer_kwargs: Any,
    ) -> None:
        super().__init__()
        self.norm1 = build_norm(norm, channels, dtype, device)
        self.dcm = DeconvMixer(channels, channels, dtype=dtype, device=device, generator=generator, **mixer_kwargs)
        self.norm2 = build_norm(norm, channels, dtype, device)
        self.mlp = MLP(channels, ratio=mlp_ratio, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.dcm(self.norm1(x))
        if isinstance(self.norm2, LayerNorm):
            ln, fc1, fc2 = self.norm2.norm, self.mlp.fc1.linear, self.mlp.fc2.linear
            return prenorm_mlp(x, ln.weight, ln.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias, self.norm2.eps)
        return x + self.mlp(self.norm2(x))


class DeconverStage(nn.Module):
    """One resolution stage: channel adapter and ``depth`` blocks; translation-invariant, so it takes no spatial size."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        depth: int = 1,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
        **block_kwargs: Any,
    ) -> None:
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.adapter = Linear(in_channels, out_channels, bias=False, **kw) if in_channels != out_channels else None
        self.blocks = nn.ModuleList(DeconverBlock(out_channels, **block_kwargs, **kw) for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.adapter is not None:
            x = self.adapter(x)
        for blk in self.blocks:
            x = blk(x)
        return x


class Stem(nn.Module):
    """Patch-embedding stem: a convolution with ``stride = kernel_size = patch_size``, then a norm."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        patch_size: Sequence[int] = (4, 4),
        norm: NormSpec = LayerNorm,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        patch = tuple(patch_size)
        self.conv = Conv(in_channels, out_channels, kernel_size=patch, stride=patch, device=device,
                         generator=generator, spatial_dims=len(patch))
        self.norm = build_norm(norm, out_channels, None, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class Deconver(UNet):
    """Deconver segmentation U-Net over volumes (``spatial_dims=3``) or images (2).

    ``kernel_size`` needs one entry per spatial axis.  Block options left out
    take :class:`Deconv`'s defaults, as in the JAX model.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        spatial_dims: int = 3,
        encoder_depth: Sequence[int] = (1, 1, 1, 1, 1),
        encoder_width: Sequence[int] = (32, 64, 128, 256, 512),
        strides: Sequence[int] = (1, 2, 2, 2, 2),
        decoder_depth: Sequence[int] = (1, 1, 1, 1),
        norm: NormSpec = LayerNorm,
        mlp_ratio: float = 4,
        act: Any = "relu",
        kernel_size: Sequence[int] = (3, 3, 3),
        source_channels: Optional[int] = None,
        ratio: float = 4,
        groups: int = 8,
        update_source: bool = True,
        update_filter: bool = False,
        eps: float = 1e-16,
        num_iters: int = 2,
        num_grad_iters: Optional[int] = None,
        remat: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        kernel_size = tuple(kernel_size)
        if len(kernel_size) != spatial_dims:
            raise ValueError(f"kernel_size {kernel_size} does not have {spatial_dims} axes")
        block_kwargs = dict(
            norm=norm, mlp_ratio=mlp_ratio, act=act, kernel_size=kernel_size, source_channels=source_channels,
            ratio=ratio, groups=groups, update_source=update_source, update_filter=update_filter, eps=eps,
            num_iters=num_iters, num_grad_iters=num_grad_iters,
        )

        def stage(i: int, cin: int, cout: int, depth: int, size: Optional[tuple]) -> nn.Module:
            return DeconverStage(cin, cout, depth, dtype=dtype, device=device, generator=generator, **block_kwargs)

        super().__init__(
            in_channels, out_channels, None, encoder_depth, encoder_width, strides, decoder_depth, stage,
            dtype=dtype, device=device, generator=generator, spatial_dims=spatial_dims, remat=remat,
        )
