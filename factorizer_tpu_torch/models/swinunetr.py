"""SwinUNETR: a 3-D Swin-transformer encoder and a convolutional UNETR decoder.

PyTorch counterpart of ``factorizer_tpu/models/swinunetr.py`` (after
Hatamizadeh et al. 2022).  Channels-last; window attention folds the volume
into ``(B * windows, window voxels, C)`` batches of matmuls, shifted windows
roll the volume and mask the pairs that the roll brought together, and patch
merging is a reshape and a Dense.  The attention is written as the JAX model
writes it: scores, relative-position bias, mask, softmax, product.

A stage the window does not divide is zero-padded after ``norm1`` and the pad
is left unmasked (MONAI's behaviour); a stage no larger than the window
clamps the window to its size and drops the shift.  The relative-position
table's size follows the clamped window, so the blocks are built for the
stage sizes that ``img_size`` gives, and an input of another size raises.

Submodules carry the Flax module names (``patch_embed``,
``stage{s}_block{b}.attn.qkv``, ``merge{s}``, ``encoder10``,
``decoder5_block``, ...); flax's bare ``nn.Dense`` and ``nn.LayerNorm`` are
:class:`~..layers.basic.Dense` and :class:`~..layers.basic.FlaxLayerNorm`
(eps 1e-6).  The ``InstanceNorm`` of the conv blocks and the k1 head take no
``dtype``, as in the JAX model, so they compute in float32 under amp.

On slabs (``parallel.slabs.on_slabs``, the spatial step) the patch
embedding (k2 stride 2), the conv blocks (halos, the InstanceNorms' whole-volume
statistics), the up-blocks' k2 transposed convolutions and the head run on the
slab; the Swin transformer, whose shifted windows of 7 span slabs, runs on the
patch embedding gathered on every process (``parallel.slabs.run_gathered``:
V2's stage convolutions inside it run as on one process), and each hidden
state it returns is cut back to the slab.  Every process computes the
transformer's whole parameter gradient, so the pair is ``count_once``: the
step's sum over the slabs counts it once.  The conv levels (level k at 1/2^k
of the volume: the patch embedding's at 1/2, ``encoder10``'s at 1/32) run on
slabs down to the first level whose slab holds no whole number of rows
(:meth:`SwinUNETR.slab_route`); that level and the deeper ones run inside the
gathered part, and the upsampling from it is cut back.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers.basic import Conv, ConvTranspose, Dense, FlaxLayerNorm, InstanceNorm, resolve_activation, truncated_normal
from ..parallel.slabs import Cut, Route, empty_route, run_gathered, run_whole
from ..utils.helpers import resolve_device, to_ntuple

__all__ = ["SwinUNETR", "WindowAttention", "SwinBlock", "PatchMerging"]


def _window_partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B*nW, prod(window), C)."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, C)


def _window_reverse(x: torch.Tensor, window: Sequence[int], dims: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`_window_partition`."""
    D, H, W = dims
    wd, wh, ww = window
    C = x.shape[-1]
    B = x.shape[0] // ((D // wd) * (H // wh) * (W // ww))
    x = x.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, C)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, C)


def _relative_position_index(window: Sequence[int]) -> np.ndarray:
    """Pairwise relative-position bucket index within a window (static): ``sum_i rel_i * prod_{j>i}(2 w_j - 1)``."""
    coords = np.stack(np.meshgrid(*[np.arange(w) for w in window], indexing="ij")).reshape(len(window), -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)  # (N, N, 3)
    rel += np.asarray(window, np.int64) - 1
    mult = np.ones(len(window), np.int64)
    for i in range(len(window) - 2, -1, -1):
        mult[i] = mult[i + 1] * (2 * window[i + 1] - 1)
    return (rel * mult).sum(-1)


def _shift_attention_mask(dims: Sequence[int], window: Sequence[int], shift: Sequence[int], device=None) -> torch.Tensor:
    """The shifted-window mask ``(nW, N, N)``, float32: -1e9 between voxels of different regions of the rolled
    volume, else 0.  Made on ``device`` at each call (at 128^3 it would be hundreds of MB to keep)."""

    def region(d: int, w: int, s: int) -> torch.Tensor:
        x = torch.arange(d, device=device)
        return (x >= d - w).to(torch.int32) + (x >= d - s).to(torch.int32)

    r = [region(d, w, s) for d, w, s in zip(dims, window, shift)]
    img = r[0][:, None, None] * 9 + r[1][None, :, None] * 3 + r[2][None, None, :]
    wins = img.reshape(dims[0] // window[0], window[0], dims[1] // window[1], window[1], dims[2] // window[2], window[2])
    wins = wins.permute(0, 2, 4, 1, 3, 5).reshape(-1, math.prod(window))
    mask = wins[:, None, :] != wins[:, :, None]
    return torch.where(mask, -1e9, 0.0).to(torch.float32)


class WindowAttention(nn.Module):
    """Multi-head self-attention within local windows, with a relative-position bias table ``(prod(2w-1), heads)``."""

    def __init__(self, dim: int, num_heads: int, window: Sequence[int], dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.num_heads, self.window = num_heads, tuple(window)
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device, generator=generator)
        n_bias = math.prod(2 * w - 1 for w in self.window)
        self.rel_pos_bias = truncated_normal((n_bias, num_heads), 0.02, device, generator)
        self.proj = Dense(dim, dim, dtype=dtype, device=device, generator=generator)
        index = torch.from_numpy(_relative_position_index(self.window))
        self.register_buffer("rel_index", index.to(device), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        Bn, N, C = x.shape
        heads = self.num_heads
        head_dim = C // heads
        q, k, v = self.qkv(x).reshape(Bn, N, 3, heads, head_dim).permute(2, 0, 3, 1, 4)  # each (Bn, H, N, hd)
        attn = (q * head_dim**-0.5) @ k.transpose(-1, -2)
        bias = self.rel_pos_bias[self.rel_index].permute(2, 0, 1)  # (H, N, N)
        attn = attn + bias[None].to(attn.dtype)
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(Bn // nW, nW, heads, N, N) + mask[None, :, None].to(attn.dtype)).reshape(Bn, heads, N, N)
        out = attn.softmax(dim=-1) @ v
        return self.proj(out.transpose(1, 2).reshape(Bn, N, C))


class SwinBlock(nn.Module):
    """Swin transformer block on ``(B, D, H, W, C)`` of size ``dims``: (S)W-MSA and an MLP with pre-norm residuals."""

    def __init__(self, dim: int, num_heads: int, window: Sequence[int], shift: Sequence[int], dims: Sequence[int],
                 mlp_ratio: float = 4.0, dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.dims = tuple(dims)
        # A stage no larger than the window clamps it to the stage and drops the shift.
        self.window = tuple(min(w, d) for w, d in zip(window, self.dims))
        self.shift = tuple(0 if w >= d else s for w, s, d in zip(window, shift, self.dims))
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.norm1 = FlaxLayerNorm(dim, dtype=dtype, device=device)
        self.attn = WindowAttention(dim, num_heads, self.window, **kw)
        self.norm2 = FlaxLayerNorm(dim, dtype=dtype, device=device)
        self.fc1 = Dense(dim, int(dim * mlp_ratio), **kw)
        self.fc2 = Dense(int(dim * mlp_ratio), dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(x.shape[1:4])
        if dims != self.dims:
            raise ValueError(f"SwinBlock built for a stage of {self.dims}, given {dims}")
        window, shift = self.window, self.shift
        h = self.norm1(x)
        pdims = tuple(-(-d // w) * w for d, w in zip(dims, window))
        if pdims != dims:
            h = F.pad(h, (0, 0, 0, pdims[2] - dims[2], 0, pdims[1] - dims[1], 0, pdims[0] - dims[0]))
        mask = None
        if any(shift):
            h = torch.roll(h, [-s for s in shift], dims=(1, 2, 3))
            mask = _shift_attention_mask(pdims, window, shift, h.device)
        h = _window_reverse(self.attn(_window_partition(h, window), mask), window, pdims)
        if any(shift):
            h = torch.roll(h, list(shift), dims=(1, 2, 3))
        if pdims != dims:
            h = h[:, : dims[0], : dims[1], : dims[2]]
        x = x + h
        h = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + h


class PatchMerging(nn.Module):
    """2x downsampling: the 2^3 neighbours concatenated in the JAX model's order -> LN -> Dense(2C)."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.norm = FlaxLayerNorm(8 * dim, dtype=dtype, device=device)
        self.reduction = Dense(8 * dim, 2 * dim, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, D, H, W, C = x.shape
        x = x.reshape(B, D // 2, 2, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
        return self.reduction(self.norm(x.reshape(B, D // 2, H // 2, W // 2, 8 * C)))


class _ConvBlock(nn.Module):
    """UNETR residual conv block: (conv3 -> IN -> leaky ReLU) x 2 and a k1-projected skip when the width changes.

    The InstanceNorms take no ``dtype`` (float32 under amp), as the JAX block's."""

    def __init__(self, in_channels: int, out_channels: int, dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.act = resolve_activation("leaky_relu")
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1, **kw)
        self.norm1 = InstanceNorm(out_channels, affine=True, device=device)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1, **kw)
        self.norm2 = InstanceNorm(out_channels, affine=True, device=device)
        self.skip = Conv(in_channels, out_channels, 1, **kw) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm2(self.conv2(self.act(self.norm1(self.conv1(x)))))
        if self.skip is not None:
            x = self.skip(x)
        return self.act(h + x)


class SwinUNETR(nn.Module):
    """Swin-UNETR for volumetric segmentation.

    Args:
        img_size: the input's spatial size (the sliding window's roi): each
            stage's window is clamped to its size.
        feature_size: embed width of the first Swin stage.
        depths / num_heads: per Swin stage.
        window_size: the attention window (7 in the bundles).
        use_v2: a residual conv block enters each Swin stage (SwinUNETR V2).
        data_format: ``"channels_first"`` takes and returns ``(B, C, D, H, W)``.
    """

    # This process's parallel.slabs.Slabs while the model runs on slabs, else None.
    slabs = None

    def slab_path_missing(self) -> Optional[str]:
        """What keeps the model from the spatial step (``parallel.slabs``): nothing (the transformer is gathered)."""
        return None

    # Each conv level's encoder (None: the hidden state enters as it is) and decoder, level k at 1/2^k of the volume.
    _ENCODERS = ("encoder1", "encoder2", "encoder3", "encoder4", None, "encoder10")
    _DECODERS = ("decoder1", "decoder2", "decoder3", "decoder4", "decoder5")

    def slab_strides(self) -> list[int]:
        """The conv levels' strides along the cut axis: level k holds ``1 / 2^k`` of the rows
        (``parallel.slabs.choose_cut``)."""
        return [2] * (len(self._ENCODERS) - 1)

    def slab_route(self, cut: Cut) -> Route:
        """The route on the cut ``cut`` (``parallel.slabs.Cut``) of the input's rows: the
        transformer gathered, and from the first conv level where some slab holds no whole number of rows (level k
        holds ``rows / 2^k``) every deeper conv level with it; the whole model on a cut with empty slabs."""
        route = empty_route(cut)
        if route is not None:
            return route
        for level in range(1, len(self._ENCODERS)):
            for size in sorted(set(cut.sizes(cut.rows))):
                if size % 2**level:
                    return Route(level, f"level {level} ({self._ENCODERS[level] or 'the skip of decoder5'}) holds "
                                        f"{size}/{2**level} rows a slab")
        return Route(None, "the transformer gathered")

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        img_size: Sequence[int] = (64, 64, 64),
        feature_size: int = 48,
        depths: Sequence[int] = (2, 2, 2, 2),
        num_heads: Sequence[int] = (3, 6, 12, 24),
        window_size: int | Sequence[int] = 7,
        mlp_ratio: float = 4.0,
        use_v2: bool = False,
        data_format: str = "channels_first",
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.depths, self.use_v2, self.data_format = tuple(depths), use_v2, data_format
        window = to_ntuple(window_size, 3)
        shift = tuple(w // 2 for w in window)
        fs = feature_size
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.patch_embed = Conv(in_channels, fs, kernel_size=2, stride=2, **kw)
        dims = tuple(s // 2 for s in to_ntuple(tuple(img_size), 3))
        dim = fs
        for s, (depth, heads) in enumerate(zip(depths, num_heads)):
            if use_v2:
                setattr(self, f"stage{s}_conv", _ConvBlock(dim, dim, **kw))
            for b in range(depth):
                blk_shift = (0, 0, 0) if b % 2 == 0 else shift
                setattr(self, f"stage{s}_block{b}", SwinBlock(dim, heads, window, blk_shift, dims, mlp_ratio, **kw))
            setattr(self, f"merge{s}", PatchMerging(dim, **kw))
            dim *= 2
            dims = tuple(d // 2 for d in dims)
        self.encoder1 = _ConvBlock(in_channels, fs, **kw)
        self.encoder2 = _ConvBlock(fs, fs, **kw)
        self.encoder3 = _ConvBlock(2 * fs, 2 * fs, **kw)
        self.encoder4 = _ConvBlock(4 * fs, 4 * fs, **kw)
        self.encoder10 = _ConvBlock(16 * fs, 16 * fs, **kw)
        for name, cin, cout in (("decoder5", 16 * fs, 8 * fs), ("decoder4", 8 * fs, 4 * fs), ("decoder3", 4 * fs, 2 * fs),
                                ("decoder2", 2 * fs, fs), ("decoder1", fs, fs)):
            setattr(self, f"{name}_up", ConvTranspose(cin, cout, kernel_size=2, stride=2, **kw))
            setattr(self, f"{name}_block", _ConvBlock(2 * cout, cout, **kw))
        self.head = Conv(fs, out_channels, kernel_size=1, device=device, generator=generator)

    def _up(self, name: str, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f"{name}_up")(x)
        return getattr(self, f"{name}_block")(torch.cat([x, skip], dim=-1))

    def _transformer(self, h: torch.Tensor) -> list[torch.Tensor]:
        """The patch embedding and every Swin stage's output after its merge, as MONAI's SwinTransformer returns them."""
        hidden = [h]
        for s, depth in enumerate(self.depths):
            if self.use_v2:
                h = getattr(self, f"stage{s}_conv")(h)
            for b in range(depth):
                h = getattr(self, f"stage{s}_block{b}")(h)
            h = getattr(self, f"merge{s}")(h)
            hidden.append(h)
        return hidden

    def _encode(self, level: int, x: torch.Tensor, hidden: list[torch.Tensor]) -> torch.Tensor:
        source = x if level == 0 else hidden[level - 1]
        name = self._ENCODERS[level]
        return source if name is None else getattr(self, name)(source)

    def _decode(self, d: torch.Tensor, hi: int, lo: int, x: torch.Tensor, hidden: list) -> torch.Tensor:
        """The decoder from level ``hi + 1``'s output ``d`` down to level ``lo``'s."""
        for level in range(hi, lo - 1, -1):
            d = self._up(self._DECODERS[level], d, self._encode(level, x, hidden))
        return d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        slabs, deepest = self.slabs, len(self._ENCODERS) - 1
        dim = 2 if self.data_format == "channels_first" else 1
        if slabs is not None and self.slab_route(slabs.line_cut(x.shape[dim])).level == 0:
            return run_whole(self, x, slabs, dim)
        if self.data_format == "channels_first":
            x = x.movedim(1, -1).contiguous()
        if slabs is None:
            hidden = self._transformer(self.patch_embed(x))
            out = self._decode(self._encode(deepest, x, hidden), deepest - 1, 0, x, hidden)
        else:
            level = self.slab_route(slabs.line_cut(x.shape[1])).level or deepest + 1

            def part(t: torch.Tensor) -> list[torch.Tensor]:
                """The transformer and the conv levels from ``level`` down, on whole tensors: the hidden states after
                the patch embedding that the levels above read, and the upsampling into level ``level - 1``."""
                hidden = self._transformer(self.patch_embed(t) if level == 1 else t)
                out = hidden[1: level - 1]
                if level <= deepest:
                    d = self._decode(self._encode(deepest, None, hidden), deepest - 1, level, None, hidden)
                    out.append(getattr(self, f"{self._DECODERS[level - 1]}_up")(d))
                return out

            h = None if level == 1 else self.patch_embed(x)
            whole = run_gathered(part, [self], slabs, x if level == 1 else h)
            hidden = ([] if level == 1 else [h]) + [slabs.cut_slab(t, count_once=True) for t in whole]
            if level <= deepest:
                name = self._DECODERS[level - 1]
                d = getattr(self, f"{name}_block")(torch.cat([hidden.pop(), self._encode(level - 1, x, hidden)], dim=-1))
                out = self._decode(d, level - 2, 0, x, hidden)
            else:
                out = self._decode(self._encode(deepest, x, hidden), deepest - 1, 0, x, hidden)
        out = self.head(out)
        return out.movedim(-1, 1) if self.data_format == "channels_first" else out
