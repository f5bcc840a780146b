"""U-Net skeleton with per-stage blocks, channels-last inside.

PyTorch counterpart of ``factorizer_tpu/models/unet.py``, laid out as the
reference torch model is (``stem``, ``encoder.blocks.{i}.downsample`` /
``.block``, ``decoder.blocks.{i}.upsample`` / ``.block``, ``head``) so its
state dict converts with ``convert_state_dict``.  The public ``forward`` takes
and returns channels-first ``(B, C, *S)``; everything between the stem and the
head is channels-last ``(B, *S, C)``.

The stem is a k3 convolution (padding 1, no bias), a stride-s stage
downsamples with a k2 stride-2 convolution, the decoder upsamples with a k2
stride-2 transposed convolution and concatenates ``[skip, up]`` on the channel
axis, and the head is a k1 convolution.  Deep supervision and
rematerialisation are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..layers.basic import Conv, ConvTranspose, Identity

__all__ = ["UNet", "StageFactory"]

# (stage index, in_channels, out_channels, depth, spatial_size) -> stage module.
# Stages 0 .. n_enc-1 are the encoder (n_enc-1 is the bottleneck), then the
# decoder stages deepest-first.
StageFactory = Callable[[int, int, int, int, tuple], nn.Module]


class _EncoderStage(nn.Module):
    def __init__(self, downsample: nn.Module, block: nn.Module) -> None:
        super().__init__()
        self.downsample = downsample
        self.block = block

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(self.downsample(x))


class _DecoderStage(nn.Module):
    def __init__(self, upsample: nn.Module, block: nn.Module) -> None:
        super().__init__()
        self.upsample = upsample
        self.block = block

    def forward(self, skip: torch.Tensor, deep: torch.Tensor) -> torch.Tensor:
        return self.block(torch.cat([skip, self.upsample(deep)], dim=-1))


class _Blocks(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module]) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class UNet(nn.Module):
    """U-shaped encoder/decoder with skip connections, over 3-D volumes.

    Args:
        in_channels / out_channels: model input / output channels.
        spatial_size: input spatial size, handed to the stage blocks.
        encoder_depth / encoder_width / strides: per encoder stage.
        decoder_depth: per decoder stage, deepest first.
        block: builds each stage's block (see :data:`StageFactory`).
        dtype: compute dtype of the stem, resampling convs and stages
            (the head computes in float32, as the JAX model's does).
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        spatial_size: Sequence[int],
        encoder_depth: Sequence[int],
        encoder_width: Sequence[int],
        strides: Sequence[int],
        decoder_depth: Sequence[int],
        block: StageFactory,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        conv_kw = dict(dtype=dtype, device=device, generator=generator)
        widths = [encoder_width[0], *encoder_width]
        self.stem = Conv(in_channels, widths[0], kernel_size=3, padding=1, bias=False, **conv_kw)

        size = tuple(spatial_size)
        encoder = []
        for i, stride in enumerate(strides[: len(encoder_depth)]):
            size = tuple(s // stride for s in size)
            if stride == 1:
                if widths[i] != widths[i + 1]:
                    raise ValueError(f"stride-1 stage {i} needs matching widths, got {widths[i]} -> {widths[i + 1]}")
                down = Identity()
            else:
                down = Conv(widths[i], widths[i + 1], kernel_size=2, stride=stride, **conv_kw)
            stage = block(i, widths[i + 1], widths[i + 1], encoder_depth[i], size)
            encoder.append(_EncoderStage(down, stage))
        self.encoder = _Blocks(encoder)

        dec_widths = list(encoder_width[::-1])
        dec_strides = list(strides[::-1][: len(decoder_depth)])
        decoder = []
        for i, stride in enumerate(dec_strides):
            size = tuple(s * stride for s in size)
            up = ConvTranspose(dec_widths[i], dec_widths[i + 1], kernel_size=2, stride=stride, **conv_kw)
            stage = block(len(encoder_depth) + i, 2 * dec_widths[i + 1], dec_widths[i + 1], decoder_depth[i], size)
            decoder.append(_DecoderStage(up, stage))
        self.decoder = _Blocks(decoder)

        self.head = Conv(encoder_width[0], out_channels, kernel_size=1, device=device, generator=generator)

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
