"""UNETR: a ViT encoder and a convolutional decoder for volumetric segmentation.

PyTorch counterpart of ``factorizer_tpu/models/unetr.py`` (MONAI's UNETR after
Hatamizadeh et al. 2021).  Channels-last; the ViT runs as batched matmuls over
the patch sequence, and the hidden states after the quarter points of the
trunk (layers 3/6/9/12 of 12) feed progressive-upsampling conv branches.

The attention is flax's ``MultiHeadDotProductAttention``: ``query``, ``key``,
``value`` and ``out`` are Dense layers over ``heads * head_dim`` features (the
weight bridge folds the Flax kernels' ``(hidden, heads, head_dim)`` axes), the
query is divided by ``sqrt(head_dim)`` and the softmax runs in the compute
dtype.  Submodules carry the Flax module names (``vit{i}``, ``vit_norm``,
``encoder2.up1``, ``decoder4_block``, ...).

On slabs (``parallel.slabs.on_slabs``, the spatial step) the patch embedding
(kernel = stride = patch), the conv branches and the head run on the slab; the
ViT, whose attention spans every patch, runs on the patch grid gathered on
every process (``parallel.slabs.run_gathered``), and each hidden state the
decoder reads is cut back to the slab (``cut_slab``), ``count_once`` as the
SwinUNETR's transformer.  A slab that holds no whole number of patches
(:meth:`UNETR.slab_route`) runs everything but the finest level gathered
(``parallel.slabs.run_gathered``: the branches climb from the patch grid
through every level), and the upsampling into the finest level is cut back.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.basic import Conv, ConvTranspose, Dense, FlaxLayerNorm, truncated_normal
from ..parallel.slabs import Cut, Route, empty_route, run_gathered, run_whole
from ..utils.helpers import resolve_device, to_ntuple
from .swinunetr import _ConvBlock as _ResBlock  # MONAI's UnetResBlock: the same layers and names

__all__ = ["UNETR"]


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` as self-attention over ``(B, L, hidden)``, no dropout."""

    def __init__(self, hidden: int, num_heads: int, dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device), generator=generator)
        self.num_heads = num_heads
        self.query = Dense(hidden, hidden, **kw)
        self.key = Dense(hidden, hidden, **kw)
        self.value = Dense(hidden, hidden, **kw)
        self.out = Dense(hidden, hidden, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        heads = self.num_heads
        hd = C // heads
        q, k, v = (m(x).reshape(B, L, heads, hd).transpose(1, 2) for m in (self.query, self.key, self.value))
        weights = ((q / math.sqrt(hd)) @ k.transpose(-1, -2)).softmax(dim=-1)
        return self.out((weights @ v).transpose(1, 2).reshape(B, L, C))


class _ViTBlock(nn.Module):
    """Pre-norm transformer block: MHA and a GELU MLP."""

    def __init__(self, hidden: int, mlp_dim: int, num_heads: int, dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.norm1 = FlaxLayerNorm(hidden, dtype=dtype, device=device)
        self.attn = MultiHeadAttention(hidden, num_heads, **kw)
        self.norm2 = FlaxLayerNorm(hidden, dtype=dtype, device=device)
        self.fc1 = Dense(hidden, mlp_dim, **kw)
        self.fc2 = Dense(mlp_dim, hidden, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class _PrUpBlock(nn.Module):
    """Progressive upsampling branch: a k2 transposed convolution, then ``num_layer`` x (another, a res block)."""

    def __init__(self, in_channels: int, out_channels: int, num_layer: int, dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device), generator=generator)
        self.num_layer = num_layer
        self.up0 = ConvTranspose(in_channels, out_channels, kernel_size=2, stride=2, **kw)
        for i in range(num_layer):
            setattr(self, f"up{i + 1}", ConvTranspose(out_channels, out_channels, kernel_size=2, stride=2, **kw))
            setattr(self, f"res{i}", _ResBlock(out_channels, out_channels, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.up0(x)
        for i in range(self.num_layer):
            x = getattr(self, f"res{i}")(getattr(self, f"up{i + 1}")(x))
        return x


class UNETR(nn.Module):
    """UNETR for volumetric segmentation (the canonical configuration: feature size 16, hidden 768, MLP 3072,
    12 heads, 12 layers, patches of 16^3).

    Args:
        img_size: the input's spatial size (the sliding window's roi), divisible by ``patch_size``.
        feature_size: the decoder's base width.
        hidden_size / mlp_dim / num_heads / num_layers: the ViT.
        data_format: ``"channels_first"`` takes and returns ``(B, C, D, H, W)``.
    """

    # This process's parallel.slabs.Slabs while the model runs on slabs, else None.
    slabs = None

    def slab_path_missing(self) -> Optional[str]:
        """What keeps the model from the spatial step (``parallel.slabs``): nothing (the ViT is gathered)."""
        return None

    def slab_strides(self) -> list[int]:
        """The patch embedding's stride along the cut axis (``parallel.slabs.choose_cut``)."""
        return [self.patch_size]

    def slab_route(self, cut: Cut) -> Route:
        """The route on the cut ``cut`` (``parallel.slabs.Cut``) of the input's rows: the ViT
        gathered; where some slab holds no whole number of patches, levels 1 and deeper with it (the patch embedding
        and the branches above the finest level); the whole model on a cut with empty slabs."""
        route = empty_route(cut)
        if route is not None:
            return route
        for size in sorted(set(cut.sizes(cut.rows))):
            if size % self.patch_size:
                return Route(1, f"a slab of {size} rows holds no whole number of patches of {self.patch_size}")
        return Route(None, "the ViT gathered")

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        img_size: Sequence[int] = (128, 128, 128),
        feature_size: int = 16,
        hidden_size: int = 768,
        mlp_dim: int = 3072,
        num_heads: int = 12,
        num_layers: int = 12,
        patch_size: int = 16,
        data_format: str = "channels_first",
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=generator)
        fs, hid = feature_size, hidden_size
        self.feat = tuple(s // patch_size for s in to_ntuple(tuple(img_size), 3))
        self.patch_size = patch_size
        self.num_layers, self.hidden, self.data_format = num_layers, hid, data_format
        # The hidden states kept: after layers 3/6/9/12 of the canonical 12.
        self.taps = [max(1, round(num_layers * k / 4)) for k in (1, 2, 3, 4)]
        self.patch_embed = Conv(in_channels, hid, kernel_size=patch_size, stride=patch_size, **kw)
        self.pos_embed = truncated_normal((1, math.prod(self.feat), hid), 0.02, device, generator)
        for i in range(num_layers):
            setattr(self, f"vit{i}", _ViTBlock(hid, mlp_dim, num_heads, **kw))
        self.vit_norm = FlaxLayerNorm(hid, dtype=dtype, device=device)
        self.encoder1 = _ResBlock(in_channels, fs, **kw)
        self.encoder2 = _PrUpBlock(hid, 2 * fs, num_layer=2, **kw)
        self.encoder3 = _PrUpBlock(hid, 4 * fs, num_layer=1, **kw)
        self.encoder4 = _PrUpBlock(hid, 8 * fs, num_layer=0, **kw)
        for name, cin, cout in (("decoder4", hid, 8 * fs), ("decoder3", 8 * fs, 4 * fs), ("decoder2", 4 * fs, 2 * fs),
                                ("decoder1", 2 * fs, fs)):
            setattr(self, f"{name}_up", ConvTranspose(cin, cout, kernel_size=2, stride=2, **kw))
            setattr(self, f"{name}_block", _ResBlock(2 * cout, cout, **kw))
        self.head = Conv(fs, out_channels, kernel_size=1, device=device, generator=generator)

    def _up(self, name: str, h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        h = getattr(self, f"{name}_up")(h)
        return getattr(self, f"{name}_block")(torch.cat([h, skip], dim=-1))

    def _states(self, z: torch.Tensor) -> list[torch.Tensor]:
        """The ViT on the whole patch grid ``z``: the four hidden states the branches read, as grids."""
        B = z.shape[0]
        z = z.reshape(B, -1, self.hidden) + self.pos_embed.to(z.dtype)
        states = {}
        for i in range(self.num_layers):
            z = getattr(self, f"vit{i}")(z)
            if i + 1 in self.taps:
                states[i + 1] = z
        states[self.taps[3]] = self.vit_norm(states[self.taps[3]])
        return [states[t].reshape(B, *self.feat, self.hidden) for t in self.taps]

    def _branches(self, grids: list[torch.Tensor]) -> torch.Tensor:
        """The conv branches from the hidden states' grids up to ``decoder2``'s output."""
        enc2, enc3, enc4 = self.encoder2(grids[0]), self.encoder3(grids[1]), self.encoder4(grids[2])
        d3 = self._up("decoder3", self._up("decoder4", grids[3], enc4), enc3)
        return self._up("decoder2", d3, enc2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        slabs = self.slabs
        dim = 2 if self.data_format == "channels_first" else 1
        if slabs is not None and self.slab_route(slabs.line_cut(x.shape[dim])).level == 0:
            return run_whole(self, x, slabs, dim)
        if self.data_format == "channels_first":
            x = x.movedim(1, -1).contiguous()
        if slabs is None:
            up = self.decoder1_up(self._branches(self._states(self.patch_embed(x))))
        else:
            def cut(t: torch.Tensor) -> torch.Tensor:
                return slabs.cut_slab(t, count_once=True)

            if self.slab_route(slabs.line_cut(x.shape[1])).level == 1:  # all but the finest level gathered
                up = cut(run_gathered(lambda t: self.decoder1_up(self._branches(self._states(self.patch_embed(t)))),
                                      [self], slabs, x))
            else:  # the ViT on the whole patch grid, on every process
                grids = run_gathered(self._states, [self], slabs, self.patch_embed(x))
                up = self.decoder1_up(self._branches([cut(g) for g in grids]))
        out = self.head(self.decoder1_block(torch.cat([up, self.encoder1(x)], dim=-1)))
        return out.movedim(-1, 1) if self.data_format == "channels_first" else out
