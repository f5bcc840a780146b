"""Generic U-Net skeleton, parameterized by per-stage block specs, channels-last inside.

PyTorch counterpart of ``factorizer_tpu/models/unet.py``, laid out as the
reference torch model is (``stem``, ``encoder.blocks.{i}.downsample`` /
``.block``, ``decoder.blocks.{i}.upsample`` / ``.block``, ``head``, or the
deep-supervision heads ``head0``, ``head1``, ...) so its state dict converts
with ``convert_state_dict``.  Between the stem and the heads everything is
channels-last ``(B, *S, C)``; ``data_format`` says whether ``forward`` takes and
returns channels-first ``(B, C, *S)`` (the default) or channels-last tensors.

Each component is a spec in the ``partialize`` idiom, ``Class | (Class,
kwargs)``, built by :func:`build_block` with the keywords its class accepts, as
the JAX model builds them: ``block`` is one spec, a :class:`Same` wrapper or a
list with one spec per stage (encoder stages first, then the decoder's,
deepest first), called with ``(in_channels, out_channels, depth=,
spatial_size=, dtype=)``; ``stem`` (None or ``Identity``: no stem, and then the
first encoder width is the input's), ``downsample`` (default a k2 convolution
of the stage's stride), ``upsample`` (a k2 transposed convolution) and ``head``
(a k1 convolution, computing in float32 as the JAX model's does).
``num_deep_supr`` (an int n, or True for 3) puts heads ``head{j}`` on the n
finest decoder outputs; ``forward`` then returns their list, finest first, in
training and evaluation alike.  Volumes (``spatial_dims=3``) and images
(``spatial_dims=2``); ``device``, ``generator`` and ``spatial_dims`` go to each
component whose class takes them.  ``remat=True`` runs each stage's block under
``torch.utils.checkpoint`` while autograd records a graph, as the JAX model
wraps it in ``nn.remat``: the block's activations are recomputed in the
backward, so the kernels' forwards launch twice per step, and a dropout mask is
drawn again from the same random state (``preserve_rng_state``).

On slabs (``parallel.slabs.on_slabs``) the skeleton's layers take their slab
paths (``layers.basic``): a convolution runs on its slab and a halo of
``padding`` rows from each neighbour, with valid padding along the cut axis;
the rest is local to the slab.  :meth:`UNet.slab_route` is the one rule for
the rest: the levels run on slabs down to the first level ℓ with a part built
of other layers than :data:`SLAB_LAYERS` (the Factorizer's and the Deconver's
stages and the patch stem judge themselves, through their own
``slab_path_missing``) or a layer whose slab holds too few rows for it (a
stride that does not divide them, fewer than one row, a halo wider than the
slab), and levels ℓ and deeper run gathered (``parallel.slabs.run_ladder``); a
stem that fails, or a cut with empty slabs (more slabs than rows), makes it the
whole model (ℓ = 0).  A head belongs to the level it reads: a gathered level's
head runs in the gathered part, and where the cut does not keep the level's
rows whole on every slab (a deep-supervision head below the cut's grid) every
process returns the head's whole output (``parallel.slabs.whole_on_slabs``),
whose loss term ``train.losses.deep_supervision_loss`` takes whole.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import Any, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..layers.basic import (
    MLP,
    Conv,
    ConvTranspose,
    Dense,
    Dropout,
    FlaxGroupNorm,
    FlaxLayerNorm,
    GroupNorm,
    Identity,
    InstanceNorm,
    LayerNorm,
    Linear,
    _Affine,
)
from ..layers.conv_blocks import BasicBlock, DoubleConv, PreActivationBlock, SepConv
from ..parallel.slabs import Cut, Route, as_now, empty_route, run_ladder, run_whole
from ..utils.helpers import has_args, partialize, spec_accepts

__all__ = ["UNet", "Same", "build_block", "dtype_kwargs", "SLAB_LAYERS", "SLAB_NORMS", "slab_path_missing_of",
           "slab_part_missing", "first_gathered_level"]

CHANNELS_FIRST = "channels_first"
CHANNELS_LAST = "channels_last"
# The default stem of the JAX Factorizer and Deconver (the generic UNet's is none).
CONV_STEM = (Conv, {"kernel_size": 3, "padding": 1, "bias": False})


class Same:
    """Indexable wrapper returning the same block spec for every stage."""

    def __init__(self, block: Any) -> None:
        self.block = block

    def __getitem__(self, idx: Any) -> Any:
        return self.block


def dtype_kwargs(spec: Any, dtype: Optional[torch.dtype]) -> dict:
    """``{"dtype": dtype}`` when it should be threaded into ``spec``: empty when ``dtype`` is None, when the spec does
    not take ``dtype``, or when it binds one itself (``(LayerNorm, {"dtype": torch.float32})`` keeps its float32)."""
    if dtype is None or not spec_accepts(spec, "dtype"):
        return {}
    if "dtype" in getattr(partialize(spec), "keywords", {}):
        return {}
    return {"dtype": dtype}


def build_block(spec: Any, *args: Any, context: Optional[dict] = None, **kwargs: Any) -> nn.Module:
    """Instantiate a block spec with the keywords its class accepts, as the JAX ``build_block`` does.

    ``dtype`` follows :func:`dtype_kwargs`; the entries of ``context`` (device,
    generator, spatial_dims: what a Flax module never needs) go where the class
    takes them.
    """
    fn = partialize(spec)
    cls = getattr(fn, "func", fn)
    kept = {k: v for k, v in kwargs.items() if spec_accepts(spec, k)}
    if "dtype" in kept and not dtype_kwargs(spec, kept["dtype"]):
        del kept["dtype"]
    bound = getattr(fn, "keywords", {})
    extra = {k: v for k, v in (context or {}).items() if k not in bound and has_args(cls, k)}
    return fn(*args, **kept, **extra)


def _run_block(block: nn.Module, remat: bool, x: torch.Tensor) -> torch.Tensor:
    """``block(x)``; under ``remat``, while autograd records a graph, checkpointed (recomputed in the backward, with
    the slabs its layers hold now: ``parallel.slabs.as_now``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(as_now(block), x, use_reentrant=False)
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

    def merge(self, skip: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
        """The block on the skip and the upsampled deeper output, joined along the channels."""
        return _run_block(self.block, self.remat, torch.cat([skip, up], dim=-1))

    def forward(self, skip: torch.Tensor, deep: torch.Tensor) -> torch.Tensor:
        return self.merge(skip, self.upsample(deep))


class _Blocks(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module]) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


# The norms that run on slabs: per voxel, or with their statistics summed over the slabs (layers.basic).
SLAB_NORMS = (LayerNorm, FlaxLayerNorm, nn.LayerNorm, InstanceNorm, GroupNorm, FlaxGroupNorm)

# The layers whose forward runs on a slab as it is, or through its own slab path (layers.basic): per-voxel layers,
# the convolutions and the norms, and the blocks made of nothing else.  A module of any other class has no known
# slab path.
SLAB_LAYERS = (
    *SLAB_NORMS, Conv, ConvTranspose, Linear, Dense, nn.Linear, _Affine, Dropout, nn.Dropout, Identity, MLP,
    nn.Sequential, nn.ModuleList, DoubleConv, BasicBlock, PreActivationBlock, SepConv, nn.GELU, nn.ReLU, nn.LeakyReLU,
    nn.SiLU, nn.Sigmoid, nn.Tanh,
)


def slab_path_missing_of(module: nn.Module, name: str) -> Optional[str]:
    """What keeps ``module`` (at ``name``) from running on slabs, or None.

    A module with its own ``slab_path_missing`` (the Factorizer's and the
    Deconver's stages, the patch stem) answers for itself; any other must be
    one of :data:`SLAB_LAYERS`, and so must its children, recursively.
    """
    own = getattr(module, "slab_path_missing", None)
    if own is not None:
        reason = own()
        return None if reason is None else f"{reason} (in {name})"
    if not isinstance(module, SLAB_LAYERS):
        return f"{type(module).__name__} ({name}) has no known slab path"
    for child, m in module.named_children():
        reason = slab_path_missing_of(m, f"{name}.{child}")
        if reason is not None:
            return reason
    return None


def slab_part_missing(module: nn.Module, name: str, rows_in: Fraction, rows_out: Fraction) -> Optional[str]:
    """What keeps a part of a model (``module`` at ``name``) from running on slabs of ``rows_in`` rows at its input
    and ``rows_out`` at its output, or None: a row count that is no whole number of at least one, no known slab path
    (:func:`slab_path_missing_of`), or a layer whose ``slab_rows_missing`` names a reason."""
    if min(rows_in, rows_out) < 1 or rows_in.denominator != 1 or rows_out.denominator != 1:
        return f"{name} on slabs of {rows_in} rows in, {rows_out} out: a slab holds less than one row"
    reason = slab_path_missing_of(module, name)
    if reason is not None:
        return reason
    for sub, m in module.named_modules():
        check = getattr(m, "slab_rows_missing", None)
        if check is not None:
            reason = check(int(rows_in), int(rows_out))
            if reason is not None:
                return f"{reason} (in {name}{'.' + sub if sub else ''})"
    return None


def first_gathered_level(levels: Sequence[Sequence[tuple]], cut: Cut) -> Route:
    """The route of a U-shaped model on ``cut``: the first level with a part that :func:`slab_part_missing` names on
    any slab of the cut (the thinnest first), where ``levels[l]`` lists level ``l``'s parts as ``(name, module,
    rows_in, rows_out)``, the whole volume's rows; every level on slabs if none; the whole model (level 0) on a cut with
    empty slabs.  Every process judges every slab's rows, so the line takes one route."""
    route = empty_route(cut)
    if route is not None:
        return route
    total = sum(cut.parts)
    shares = [Fraction(p, total) for p in sorted(set(cut.parts))]
    for level, parts in enumerate(levels):
        for name, module, rows_in, rows_out in parts:
            for share in shares:
                reason = slab_part_missing(module, name, rows_in * share, rows_out * share)
                if reason is not None:
                    return Route(level, reason)
    return Route()


class UNet(nn.Module):
    """Generic U-shaped encoder/decoder with skip connections, over 3-D volumes or 2-D images.

    Args mirror the JAX model's (and the reference constructor's):
        in_channels / out_channels: model input / output channels.
        spatial_size: input spatial size, handed to the stage blocks that take it; None if none needs it.
        encoder_depth / encoder_width / strides: per encoder stage; stage i downsamples by ``strides[i]``
            (stride 1: no downsampling, and matching widths).
        decoder_depth: per decoder stage, deepest first.
        stem / downsample / block / upsample / head: component specs (see the module).
        num_deep_supr: False for one full-resolution head, an int n for n deep-supervision heads, True for 3.
        data_format: ``"channels_first"`` or ``"channels_last"``, the layout of ``forward``'s input and outputs.
        dtype: compute dtype of the components that take one (not the heads).
        spatial_dims: 3 or 2, handed to the components that take it.
        remat: recompute each stage block's activations in the backward (JAX ``remat``).
    """

    # The prefix of this model's parameters among the JAX model's variables: the JAX Factorizer and Deconver hold
    # their U-Net under ``unet``, the JAX UNet is the U-Net itself.
    flax_prefix = ""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        spatial_size: Optional[Sequence[int]] = None,
        encoder_depth: Sequence[int] = (1, 1, 1, 1, 1),
        encoder_width: Sequence[int] = (32, 64, 128, 256, 512),
        strides: Sequence[int] = (1, 2, 2, 2, 2),
        decoder_depth: Sequence[int] = (1, 1, 1, 1),
        stem: Any = None,
        downsample: Any = None,
        block: Any = None,
        upsample: Any = None,
        head: Any = None,
        num_deep_supr: Any = False,
        data_format: str = CHANNELS_FIRST,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
        spatial_dims: int = 3,
        remat: bool = False,
    ) -> None:
        super().__init__()
        if spatial_size is not None and len(spatial_size) != spatial_dims:
            raise ValueError(f"spatial_size {tuple(spatial_size)} does not have {spatial_dims} axes")
        if data_format not in (CHANNELS_FIRST, CHANNELS_LAST):
            raise ValueError(f"data_format must be {CHANNELS_FIRST!r} or {CHANNELS_LAST!r}, got {data_format!r}")
        self.data_format = data_format
        n_enc, n_dec = len(encoder_depth), len(decoder_depth)
        self.strides = tuple(strides[:n_enc])
        ctx = dict(device=device, generator=generator, spatial_dims=spatial_dims)

        # Per-stage block specs, encoder stages first, then the decoder's.
        if block is None:
            block = Same((DoubleConv, {}))
        if isinstance(block, Same) or not isinstance(block, (list, tuple)):
            block = block if isinstance(block, Same) else Same(block)
            blocks = [block[i] for i in range(n_enc + n_dec)]
        else:
            blocks = list(block)

        if stem in (None, Identity):
            stem_width = in_channels
            self.stem = Identity()
        else:
            stem_width = encoder_width[0]
            self.stem = build_block(stem, in_channels, stem_width, context=ctx, dtype=dtype)
        downsample = downsample or (Conv, {"kernel_size": 2})
        upsample = upsample or (ConvTranspose, {"kernel_size": 2})
        head = head or (Conv, {"kernel_size": 1})

        widths = [stem_width, *encoder_width]
        size = None if spatial_size is None else tuple(spatial_size)
        encoder = []
        for i in range(n_enc):
            stride = strides[i]
            size = None if size is None else tuple(s // stride for s in size)
            if stride == 1:
                if widths[i] != widths[i + 1]:
                    raise ValueError(
                        "stride-1 encoder stage requires matching widths "
                        f"(got {widths[i]} -> {widths[i + 1]}); stage blocks adapt channels."
                    )
                down = Identity()
            else:
                down = build_block(downsample, widths[i], widths[i + 1], context=ctx, stride=stride, dtype=dtype)
            stage = build_block(blocks[i], widths[i + 1], widths[i + 1], context=ctx, depth=encoder_depth[i],
                                spatial_size=size, dtype=dtype)
            encoder.append(_EncoderStage(down, stage, remat))
        self.encoder = _Blocks(encoder)

        dec_widths = list(encoder_width[::-1])
        dec_strides = list(strides[::-1][:n_dec])
        decoder = []
        for i, stride in enumerate(dec_strides):
            size = None if size is None else tuple(s * stride for s in size)
            up = build_block(upsample, dec_widths[i], dec_widths[i + 1], context=ctx, stride=stride, dtype=dtype)
            stage = build_block(blocks[n_enc + i], 2 * dec_widths[i + 1], dec_widths[i + 1], context=ctx,
                                depth=decoder_depth[i], spatial_size=size, dtype=dtype)
            decoder.append(_DecoderStage(up, stage, remat))
        self.decoder = _Blocks(decoder)

        if num_deep_supr in (False, None, 0):
            self.num_deep_supr = 0
            self.head = build_block(head, encoder_width[0], out_channels, context=ctx)
        else:
            self.num_deep_supr = 3 if num_deep_supr is True else int(num_deep_supr)
            for j in range(self.num_deep_supr):
                self.add_module(f"head{j}", build_block(head, encoder_width[j], out_channels, context=ctx))

    # This process's parallel.slabs.Slabs while the model runs on slabs, else None.
    slabs = None

    def head_names(self) -> list[str]:
        """The output heads' names, finest first: ``head``, or ``head0 .. head{n-1}`` under deep supervision."""
        return [f"head{j}" for j in range(self.num_deep_supr)] if self.num_deep_supr else ["head"]

    def slab_path_missing(self) -> Optional[str]:
        """None: every part runs on slabs or, where it has no slab path, gathered (:meth:`slab_route`)."""
        return None

    def slab_strides(self) -> list[int]:
        """The strides along the cut axis from the input: the stem's (its convolutions' strides folded) and each
        encoder stage's (``parallel.slabs.choose_cut``)."""
        return [math.prod(m.stride[0] for m in self.stem.modules() if isinstance(m, Conv)), *self.strides]

    def _level_rows(self, rows: int) -> list[Fraction]:
        """The whole volume's rows at the stem's output and at each encoder level, from ``rows`` at the input."""
        out = [Fraction(rows)]
        for stride in self.slab_strides():
            out.append(out[-1] / stride)
        return out[1:]

    def slab_route(self, cut: Cut) -> Route:
        """The route on the cut ``cut`` (``parallel.slabs.Cut``) of the input's rows: the
        first level with a part that has no slab path or too few rows on some slab for one of its layers, and all
        deeper levels, run gathered.  Level ``l``'s parts: encoder stage ``l`` (its resampling layer and block), the
        decoder block at level ``l``, the upsampling from it and the head that reads level ``l``; level 0 also the stem.
        A head of a gathered level runs in the gathered part, on the whole level."""
        rs = self._level_rows(cut.rows)
        n_enc = len(self.encoder.blocks)
        levels = [[] for _ in range(n_enc)]
        levels[0] += [("stem", self.stem, Fraction(cut.rows), rs[0])]
        for i, stage in enumerate(self.encoder.blocks):
            levels[i] += [(f"encoder.blocks.{i}.{name}", m, rs[i], rs[i + 1]) for name, m in stage.named_children()]
        for k, stage in enumerate(self.decoder.blocks):
            lv = n_enc - 2 - k  # the level this stage's block runs at; its upsampling comes from the level below
            levels[lv] += [(f"decoder.blocks.{k}.block", stage.block, rs[lv], rs[lv + 1])]
            levels[lv + 1] += [(f"decoder.blocks.{k}.upsample", stage.upsample, rs[lv + 1], rs[lv + 2])]
        for name, j in zip(self.head_names(), self._heads()):
            levels[j] += [(name, getattr(self, name), rs[j + 1], rs[j + 1])]
        return first_gathered_level(levels, cut)

    def _heads(self) -> list[int]:
        """The levels the heads read, finest first."""
        return list(range(max(self.num_deep_supr, 1)))

    def forward_features(self, x: torch.Tensor, level: Optional[int] = None, heads: Optional[dict] = None,
                         head_dim: int = 1) -> list[torch.Tensor]:
        """Channels-last feature pass; returns the outputs the heads read, finest first: the decoder's at each level it
        reaches, else the encoder's.  ``level``: on slabs, the first level that runs gathered (:meth:`slab_route`).
        ``heads`` (level -> function): each level's head output instead, whose cut axis is ``head_dim`` (a gathered
        level's head runs in the gathered part: ``parallel.slabs.run_ladder``)."""
        n_enc = len(self.encoder.blocks)
        up, merge = {}, {}
        for k, stage in enumerate(self.decoder.blocks):
            up[n_enc - 2 - k], merge[n_enc - 2 - k] = stage.upsample, stage.merge
        keep = self._heads()
        outs = run_ladder(self.stem(x), list(self.encoder.blocks), up, merge, keep, level, self.slabs, [self], heads,
                          head_dim)
        return [outs[j] for j in keep]

    def _head(self, name: str, y: torch.Tensor) -> torch.Tensor:
        out = getattr(self, name)(y)
        return out.movedim(-1, 1) if self.data_format == CHANNELS_FIRST else out

    def forward(self, x: torch.Tensor):
        """``(B, C_in, *S) -> (B, C_out, *S)`` (channels-last under ``data_format="channels_last"``), or the list of
        the deep-supervision heads' outputs, finest first.  On slabs, by the route of :meth:`slab_route`; a head whose
        level the cut does not keep whole on every slab returns its whole output on every process
        (``parallel.slabs.whole_on_slabs``)."""
        level, slabs = None, self.slabs
        dim = 2 if self.data_format == CHANNELS_FIRST else 1
        if slabs is not None:
            level = self.slab_route(slabs.line_cut(x.shape[dim])).level
            if level == 0:
                return run_whole(self, x, slabs, dim)
        if self.data_format == CHANNELS_FIRST:
            x = x.movedim(1, -1).contiguous()
        heads = {j: functools.partial(self._head, name) for name, j in zip(self.head_names(), self._heads())}
        outs = self.forward_features(x, level, heads, dim)
        return outs if self.num_deep_supr else outs[0]
