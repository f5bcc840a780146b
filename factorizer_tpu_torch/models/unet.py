"""U-Net skeleton with per-stage blocks, channels-last inside.

PyTorch counterpart of ``factorizer_tpu/models/unet.py``, laid out as the
reference torch model is (``stem``, ``encoder.blocks.{i}.downsample`` /
``.block``, ``decoder.blocks.{i}.upsample`` / ``.block``, ``head``) so its
state dict converts with ``convert_state_dict``.  The public ``forward`` takes
and returns channels-first ``(B, C, *S)``; everything between the stem and the
head is channels-last ``(B, *S, C)``.

Volumes (``spatial_dims=3``) and images (``spatial_dims=2``).  The stem is a k3 convolution (padding 1, no bias), a stride-s stage
downsamples with a k2 stride-2 convolution, the decoder upsamples with a k2
stride-2 transposed convolution and concatenates ``[skip, up]`` on the channel
axis, and the head is a k1 convolution.  ``remat=True`` runs each stage's
block under ``torch.utils.checkpoint`` while autograd records a graph, as the
JAX model wraps it in ``nn.remat``: the block's activations are recomputed in
the backward, so the kernels' forwards launch twice per step.  Deep
supervision is not ported yet.

On slabs (``parallel.slabs.on_slabs``) the skeleton's layers take their slab
paths (``layers.basic``): the stem runs on its slab and a halo of ``padding``
rows from each neighbour, with valid padding along the cut axis; each
stride-s downsampling needs a row count per slab that s divides (else the
:class:`Conv` raises, naming itself); the rest is local to the slab.  Whether
the stage blocks have slab paths is the subclass's to say
(``slab_path_missing``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..layers.basic import Conv, ConvTranspose, Identity

__all__ = ["UNet", "StageFactory"]

# (stage index, in_channels, out_channels, depth, spatial_size) -> stage module.
# Stages 0 .. n_enc-1 are the encoder (n_enc-1 is the bottleneck), then the
# decoder stages deepest-first.  ``spatial_size`` is None when the U-Net was
# given none (translation-invariant stages need none).
StageFactory = Callable[[int, int, int, int, Optional[tuple]], nn.Module]


def _run_block(block: nn.Module, remat: bool, x: torch.Tensor) -> torch.Tensor:
    """``block(x)``; under ``remat``, while autograd records a graph, checkpointed (recomputed in the backward)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False)
    return block(x)


class _EncoderStage(nn.Module):
    def __init__(self, downsample: nn.Module, block: nn.Module, remat: bool) -> None:
        super().__init__()
        self.downsample = downsample
        self.block = block
        self.remat = remat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _run_block(self.block, self.remat, self.downsample(x))


class _DecoderStage(nn.Module):
    def __init__(self, upsample: nn.Module, block: nn.Module, remat: bool) -> None:
        super().__init__()
        self.upsample = upsample
        self.block = block
        self.remat = remat

    def forward(self, skip: torch.Tensor, deep: torch.Tensor) -> torch.Tensor:
        return _run_block(self.block, self.remat, torch.cat([skip, self.upsample(deep)], dim=-1))


class _Blocks(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module]) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class UNet(nn.Module):
    """U-shaped encoder/decoder with skip connections, over 3-D volumes or 2-D images.

    Args:
        in_channels / out_channels: model input / output channels.
        spatial_size: input spatial size, handed to the stage blocks; None if no stage needs it.
        encoder_depth / encoder_width / strides: per encoder stage.
        decoder_depth: per decoder stage, deepest first.
        block: builds each stage's block (see :data:`StageFactory`).
        dtype: compute dtype of the stem, resampling convs and stages
            (the head computes in float32, as the JAX model's does).
        spatial_dims: 3 or 2, the rank of the convolutions.
        remat: recompute each stage block's activations in the backward (JAX ``remat``).
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        spatial_size: Optional[Sequence[int]],
        encoder_depth: Sequence[int],
        encoder_width: Sequence[int],
        strides: Sequence[int],
        decoder_depth: Sequence[int],
        block: StageFactory,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
        spatial_dims: int = 3,
        remat: bool = False,
    ) -> None:
        super().__init__()
        if spatial_size is not None and len(spatial_size) != spatial_dims:
            raise ValueError(f"spatial_size {tuple(spatial_size)} does not have {spatial_dims} axes")
        conv_kw = dict(dtype=dtype, device=device, generator=generator, spatial_dims=spatial_dims)
        widths = [encoder_width[0], *encoder_width]
        self.stem = Conv(in_channels, widths[0], kernel_size=3, padding=1, bias=False, **conv_kw)

        size = None if spatial_size is None else tuple(spatial_size)
        encoder = []
        for i, stride in enumerate(strides[: len(encoder_depth)]):
            size = None if size is None else tuple(s // stride for s in size)
            if stride == 1:
                if widths[i] != widths[i + 1]:
                    raise ValueError(f"stride-1 stage {i} needs matching widths, got {widths[i]} -> {widths[i + 1]}")
                down = Identity()
            else:
                down = Conv(widths[i], widths[i + 1], kernel_size=2, stride=stride, **conv_kw)
            stage = block(i, widths[i + 1], widths[i + 1], encoder_depth[i], size)
            encoder.append(_EncoderStage(down, stage, remat))
        self.encoder = _Blocks(encoder)

        dec_widths = list(encoder_width[::-1])
        dec_strides = list(strides[::-1][: len(decoder_depth)])
        decoder = []
        for i, stride in enumerate(dec_strides):
            size = None if size is None else tuple(s * stride for s in size)
            up = ConvTranspose(dec_widths[i], dec_widths[i + 1], kernel_size=2, stride=stride, **conv_kw)
            stage = block(len(encoder_depth) + i, 2 * dec_widths[i + 1], dec_widths[i + 1], decoder_depth[i], size)
            decoder.append(_DecoderStage(up, stage, remat))
        self.decoder = _Blocks(decoder)

        self.head = Conv(encoder_width[0], out_channels, kernel_size=1, device=device, generator=generator,
                         spatial_dims=spatial_dims)

    # This process's parallel.slabs.Slabs while the model runs on slabs, else None.
    slabs = None

    def slab_path_missing(self) -> Optional[str]:
        """What keeps the model from running on slabs, or None; the skeleton has a slab path, the stage blocks decide."""
        return f"{type(self).__name__}: its stage blocks are not known to be local to a slab"

    def forward_features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Channels-last feature pass; returns the decoder pyramid, finest first."""
        out = self.stem(x)
        ys = []
        for stage in self.encoder.blocks:
            out = stage(out)
            ys.append(out)
        for i, stage in enumerate(self.decoder.blocks):
            ys[-2 - i] = stage(ys[-2 - i], ys[-1 - i])
        return ys

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, C_in, *S) -> (B, C_out, *S)``."""
        y = self.head(self.forward_features(x.movedim(1, -1).contiguous())[0])
        return y.movedim(-1, 1)
