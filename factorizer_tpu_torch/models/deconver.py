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
  (``ops.kernels.prenorm_mlp``) where ``layers.basic.prenorm_mlp_reason``
  allows it (a :class:`LayerNorm`, K2's widths, no active dropout); otherwise
  (the bundles use :class:`InstanceNorm`) the tail is stock PyTorch.

``remat=True`` recomputes each stage's activations in the backward
(:class:`~factorizer_tpu_torch.models.unet.UNet`).  On slabs
(``parallel.slabs.on_slabs``, the spatial step) the skeleton's convolutions
and the norms take their slab paths (``layers.basic``), each of ``Deconv``'s
three convolutions a step runs K3 on its slab and a halo, the filter update
(``update_filter``) sums its slabs' partial correlations, and the projections
and tails are per voxel; the route is ``UNet.slab_route``'s.  The JAX model's ``stem`` (the
patch-embedding :class:`Stem` among the specs), ``downsample``, ``upsample``,
``head``, ``num_deep_supr`` and ``data_format`` go to the
:class:`~factorizer_tpu_torch.models.unet.UNet`; ``dropout`` follows each
mixer's ``out_proj`` and the MLP's two sites (each process draws its own masks
on slabs), and the stage's ``adapter`` is a spec, as in the JAX model.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..factorization.deconv import Deconv
from ..layers.basic import Conv, Dropout, LayerNorm, Linear, MLP, NormSpec, build_norm, prenorm_mlp_tail, resolve_activation
from .unet import CONV_STEM, UNet, build_block, slab_path_missing_of

__all__ = ["DeconvMixer", "DeconverBlock", "DeconverStage", "Stem", "Deconver"]

class DeconvMixer(nn.Module):
    """Token mixing: project -> act -> deconvolve -> project -> dropout.  ``deconv_kwargs`` go to :class:`Deconv`."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        act: Any = "relu",
        dropout: float = 0.0,
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
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.out_proj(self.deconv(self.act(self.in_proj(x)))))


class DeconverBlock(nn.Module):
    """Pre-norm residual block: ``x + dcm(norm1(x))``, then ``x + mlp(norm2(x))`` (K2 where ``prenorm_mlp_reason``
    allows it); ``dropout`` goes to the mixer and both of the MLP's sites."""

    def __init__(
        self,
        channels: int,
        norm: NormSpec = LayerNorm,
        dropout: float = 0.0,
        mlp_ratio: float = 4,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
        **mixer_kwargs: Any,
    ) -> None:
        super().__init__()
        self.norm1 = build_norm(norm, channels, dtype, device)
        self.dcm = DeconvMixer(channels, channels, dropout=dropout, dtype=dtype, device=device, generator=generator,
                               **mixer_kwargs)
        self.norm2 = build_norm(norm, channels, dtype, device)
        self.mlp = MLP(channels, ratio=mlp_ratio, dropout=dropout, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.dcm(self.norm1(x))
        return prenorm_mlp_tail(self.norm2, self.mlp, x)


class DeconverStage(nn.Module):
    """One resolution stage: channel adapter (the ``adapter`` spec, ``(Linear, {"bias": False})`` by default) and
    ``depth`` blocks; translation-invariant, so it takes no spatial size."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        depth: int = 1,
        adapter: Any = (Linear, {"bias": False}),
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
        **block_kwargs: Any,
    ) -> None:
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.adapter = (build_block(adapter, in_channels, out_channels, context={"device": device, "generator": generator},
                                    dtype=dtype)
                        if in_channels != out_channels else None)
        self.blocks = nn.ModuleList(DeconverBlock(out_channels, **block_kwargs, **kw) for _ in range(depth))

    def slab_path_missing(self) -> Optional[str]:
        """What keeps the stage from running on slabs (``parallel.slabs``), or None (the model's route then gathers
        it): an adapter without a known slab path.  The source and filter updates have slab paths (``Deconv``)."""
        return None if self.adapter is None else slab_path_missing_of(self.adapter, "adapter")

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

    def slab_path_missing(self) -> Optional[str]:
        """None where the norm has a slab path: the convolution's kernel equals its stride, so each slab of a row
        count the patch divides embeds on its own (``Conv`` raises on another)."""
        return slab_path_missing_of(self.norm, "norm")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class Deconver(UNet):
    """Deconver segmentation U-Net over volumes (``spatial_dims=3``) or images (2).

    A :class:`UNet` whose stage blocks are :class:`DeconverStage`, with the
    JAX model's default stem ``(Conv, {"kernel_size": 3, "padding": 1,
    "bias": False})``.  ``kernel_size`` needs one entry per spatial axis.
    Block options left out take :class:`Deconv`'s defaults, as in the JAX
    model.
    """

    flax_prefix = "unet."

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        spatial_dims: int = 3,
        encoder_depth: Sequence[int] = (1, 1, 1, 1, 1),
        encoder_width: Sequence[int] = (32, 64, 128, 256, 512),
        strides: Sequence[int] = (1, 2, 2, 2, 2),
        decoder_depth: Sequence[int] = (1, 1, 1, 1),
        stem: Any = None,
        downsample: Any = None,
        upsample: Any = None,
        head: Any = None,
        num_deep_supr: Any = False,
        data_format: str = "channels_first",
        norm: NormSpec = LayerNorm,
        dropout: float = 0.0,
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
            norm=norm, dropout=dropout, mlp_ratio=mlp_ratio, act=act, kernel_size=kernel_size,
            source_channels=source_channels, ratio=ratio, groups=groups, update_source=update_source,
            update_filter=update_filter, eps=eps, num_iters=num_iters, num_grad_iters=num_grad_iters,
        )
        n_stages = len(encoder_depth) + len(decoder_depth)
        super().__init__(
            in_channels, out_channels, None, encoder_depth, encoder_width, strides, decoder_depth,
            stem=CONV_STEM if stem is None else stem,
            downsample=downsample, block=n_stages * [(DeconverStage, block_kwargs)], upsample=upsample, head=head,
            num_deep_supr=num_deep_supr, data_format=data_format, dtype=dtype, device=device, generator=generator,
            spatial_dims=spatial_dims, remat=remat,
        )
