"""Factorizer models: NMF-mixing pre-norm blocks in a U-Net.

PyTorch counterpart of ``factorizer_tpu/models/factorizer.py``
(FactMixer -> FactorizerBlock -> FactorizerStage -> Factorizer), channels-last
inside, over 3-D volumes or 2-D images (``spatial_size`` of length 3 or 2).
Three kernels carry the blocks:

* ``FactMixer``, the windowed route: every 3-D (SW)Matricize mixer with a
  head_dim, cubic patches and a rank-1 hals/mu NMF goes through K1
  (``ops.kernels.windowed_nmf``), which never materialises the fold.
* ``FactMixer``, the flat route: every other mixer (2-D, rank above 1,
  non-cubic patches) and every mixer under
  ``factorize_options={"use_windowed": False}`` runs fold -> NMF -> unfold,
  where the NMF goes through K4 (``ops.kernels.nmf_reconstruct``) whenever
  its matrices fit the kernel, else through the plain ``decompose`` chain
  (the default global ``Matricize``).  The two routes compute the same
  function.
* ``FactorizerBlock`` sends its tail ``x + mlp(norm2(x))`` through K2
  (``ops.kernels.prenorm_mlp``), reading the ``norm2`` and ``mlp`` parameters,
  when ``norm`` is :class:`LayerNorm` (the default and the bundles' choice);
  under any other norm (e.g. :class:`InstanceNorm`) the tail is stock PyTorch,
  as ``DeconverBlock`` decides.

The bundles' ``network_def`` keys ``norm``, ``factorize`` and ``remat`` are
taken as the JAX model takes them.  ``factorize`` is :class:`NMF`, the one
factorizer the bundles pass; the JAX package's others are not ported.

With ``factorize_options={"spatial_mesh": mesh, "spatial_axis": name}`` a
windowed mixer runs on a slab of the volume, cut along the first spatial axis
over that axis of the process mesh, through K5
(``ops.kernels.windowed_nmf_multi_spatial``: the slab kernels and a halo
exchange); ``spatial_size`` stays the whole volume's.  Everything else in a
block is per voxel and needs nothing; a stage's positional embedding is cut
to the slab's rows.

in_proj, out_proj, the stage adapter, the folds and the convolutions stay
stock PyTorch.  Dropout is not ported: the serving path runs without it.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..factorization.nmf import NMF
from ..layers.basic import ACTIVATIONS, LayerNorm, Linear, MLP, NormSpec, build_norm
from ..layers.pos_embed import PositionalEmbedding
from ..ops.kernels import prenorm_mlp, windowed_nmf, windowed_nmf_multi_spatial
from ..ops.reshape import Matricize, SWMatricize
from .unet import UNet

__all__ = ["FactMixer", "FactorizerBlock", "FactorizerStage", "Factorizer"]

# Reshape spec: (class, keyword arguments), as the bundle configs write it.
ReshapeSpec = tuple[type, dict]
DEFAULT_RESHAPE: ReshapeSpec = (Matricize, {"num_heads": 1, "grid_size": 1})
# What ``factorize_options`` may hold.  The JAX package's other keys steer its
# TPU kernels (``use_pallas``, ``explain``); here ``reference_kernels()`` is
# the pure-torch mode.
FACTORIZE_OPTIONS = ("use_windowed", "spatial_mesh", "spatial_axis")


def _spatial_option(factorize_options: Optional[dict]) -> Optional[tuple]:
    """``(mesh, axis)`` when the options cut the volume's first spatial axis over a mesh axis, else None."""
    mesh = (factorize_options or {}).get("spatial_mesh")
    if mesh is None:
        return None
    axis = factorize_options.get("spatial_axis", "model")
    mesh.axis_size(axis)  # raises on an axis the mesh lacks
    return mesh, axis


class FactMixer(nn.Module):
    """Token mixing: project -> act -> fold -> factorize -> unfold -> project.

    ``factorize`` is the factorizer class (:class:`NMF`, the only one
    ported); ``factorize_kwargs`` go to it (``rank``, ``num_iters``,
    ``num_grad_steps``, ``init_method``, ``solver``).
    ``factorize_options={"use_windowed": False}`` takes a mixer that K1 would
    compute to the flat route instead (fold -> NMF -> unfold, K4).  It is the
    JAX package's opt-out, kept so that its configurations carry over and so
    that the two routes can be held against each other; on one card the flat
    route is the slower one and needs more memory (it copies the tensor for
    every shift), so no single-card deployment should set it.
    ``factorize_options={"spatial_mesh": mesh, "spatial_axis": "model"}``:
    ``forward`` takes this process's slab ``(B, S1 / n, S2, S3, C)`` of the
    volume and mixes it through K5; only a mixer that K1 computes can, and
    each slab must hold whole windows.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        spatial_size: Sequence[int],
        reshape: ReshapeSpec = DEFAULT_RESHAPE,
        act: str = "relu",
        factorize_kwargs: Optional[dict[str, Any]] = None,
        factorize_options: Optional[dict[str, Any]] = None,
        factorize: Any = NMF,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if factorize is not NMF:
            name = getattr(factorize, "__name__", repr(factorize))
            raise NotImplementedError(f"factorize={name} is not ported: the Factorizer takes NMF")
        unknown = sorted(set(factorize_options or {}) - set(FACTORIZE_OPTIONS))
        if unknown:
            raise ValueError(f"factorize_options takes {FACTORIZE_OPTIONS}, got {unknown}")
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.in_proj = Linear(in_channels, out_channels, bias=False, **kw)
        cls, reshape_kwargs = reshape
        self.reshape = cls((None, *spatial_size, out_channels), **reshape_kwargs)
        self.act = ACTIVATIONS[act]
        self.factorize = factorize(tuple(self.reshape.output_size[2:]), device=device, generator=generator,
                                   **(factorize_kwargs or {}))
        self.out_proj = Linear(out_channels, out_channels, bias=True, **kw)
        opted_out = (factorize_options or {}).get("use_windowed") is False
        self.windowed = None if opted_out else self._windowed_config(len(spatial_size))
        self.spatial = _spatial_option(factorize_options)
        if self.spatial is not None:
            if self.windowed is None:
                raise ValueError(
                    "factorize_options['spatial_mesh'] needs a mixer that the windowed kernel computes (3-D, a head_dim, "
                    "cubic patches, rank-1 hals or mu, use_windowed not False): the flat route has no sharded form"
                )
            mesh, axis = self.spatial
            n, patch = mesh.axis_size(axis), self.windowed[1]
            if spatial_size[0] % n or (spatial_size[0] // n) % patch:
                raise ValueError(
                    f"spatial_mesh: {spatial_size[0]} rows over {n} processes of axis {axis!r} do not give slabs of a "
                    f"whole number of patches of {patch}"
                )
            self.slab_rows = spatial_size[0] // n

    def _windowed_config(self, spatial_dims: int) -> Optional[tuple[int, int, tuple]]:
        """``(head_dim, patch, shifts)`` when K1 computes this mixer, else None."""
        if isinstance(self.reshape, SWMatricize):
            mats = self.reshape.shifted_windows
        elif isinstance(self.reshape, Matricize):
            mats = [self.reshape]
        else:
            return None
        ax = mats[0].axis_sizes
        ps = [ax.get(f"p{i}") for i in range(3)]
        fact = self.factorize
        if (
            spatial_dims != 3
            or "d" not in ax
            or ps[0] is None
            or ps.count(ps[0]) != 3
            or fact.rank != 1
            or fact.solver not in ("hals", "mu")
        ):
            return None
        return ax["d"], ps[0], tuple(m.shifts for m in mats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.act(self.in_proj(x))  # elementwise, so it commutes with the fold
        if self.windowed is not None:
            fact = self.factorize
            args = (out, fact.init.u0, fact.init.v0, *self.windowed, fact.solver, fact.num_iters, fact.eps,
                    fact.num_grad_steps)
            if self.spatial is None:
                out = windowed_nmf(*args)
            else:
                if out.shape[1] != self.slab_rows:
                    raise ValueError(f"spatial_mesh: expected a slab of {self.slab_rows} rows, got shape {tuple(out.shape)}")
                mesh, axis = self.spatial
                out = windowed_nmf_multi_spatial(*args, mesh=mesh, axis_name=axis)
        else:
            out = self.reshape.inverse_forward(self.factorize(self.reshape.forward(out)))
        return self.out_proj(out)


class FactorizerBlock(nn.Module):
    """Pre-norm residual block: ``x + fact(norm1(x))``, then ``x + mlp(norm2(x))`` (K2 under LayerNorm)."""

    def __init__(
        self,
        channels: int,
        spatial_size: Sequence[int],
        mlp_ratio: float = 2,
        reshape: ReshapeSpec = DEFAULT_RESHAPE,
        act: str = "relu",
        factorize_kwargs: Optional[dict[str, Any]] = None,
        factorize_options: Optional[dict[str, Any]] = None,
        norm: NormSpec = LayerNorm,
        factorize: Any = NMF,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.norm1 = build_norm(norm, channels, dtype, device)
        self.fact = FactMixer(channels, channels, spatial_size, reshape, act, factorize_kwargs, factorize_options,
                              factorize, dtype=dtype, device=device, generator=generator)
        self.norm2 = build_norm(norm, channels, dtype, device)
        self.mlp = MLP(channels, ratio=mlp_ratio, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.fact(self.norm1(x))
        if isinstance(self.norm2, LayerNorm):
            ln, fc1, fc2 = self.norm2.norm, self.mlp.fc1.linear, self.mlp.fc2.linear
            return prenorm_mlp(x, ln.weight, ln.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias, self.norm2.eps)
        return x + self.mlp(self.norm2(x))


class FactorizerStage(nn.Module):
    """One resolution stage: channel adapter, optional positional embedding, ``depth`` blocks.

    Under ``factorize_options["spatial_mesh"]`` the stage runs on a slab and
    adds the slab's rows of the embedding.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        spatial_size: Sequence[int],
        depth: int = 1,
        pos_embed: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
        **block_kwargs: Any,
    ) -> None:
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.adapter = Linear(in_channels, out_channels, bias=False, **kw) if in_channels != out_channels else None
        self.pos_embed = (
            PositionalEmbedding(out_channels, tuple(spatial_size), device=device, generator=generator)
            if pos_embed
            else None
        )
        self.spatial = _spatial_option(block_kwargs.get("factorize_options"))
        self.blocks = nn.ModuleList(
            FactorizerBlock(out_channels, spatial_size, **block_kwargs, **kw) for _ in range(depth)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.adapter is not None:
            x = self.adapter(x)
        if self.pos_embed is not None:
            rows = None
            if self.spatial is not None:  # x is this process's slab of the volume
                start = self.spatial[0].axis_index(self.spatial[1]) * x.shape[1]
                rows = slice(start, start + x.shape[1])
            x = self.pos_embed(x, rows)
        for blk in self.blocks:
            x = blk(x)
        return x


class Factorizer(UNet):
    """Swin-Factorizer segmentation U-Net; the bottleneck stage carries a positional embedding.

    Factorization options left at None take :class:`NMF`'s defaults, as in the
    JAX model.  ``spatial_size`` of length 2 builds the 2-D model, whose mixers
    take the flat route; ``factorize_options`` goes to every :class:`FactMixer`.
    ``norm``, ``factorize`` and ``remat`` are the bundles' keys of the same
    names: the blocks' norm, the factorizer (:class:`NMF`) and
    rematerialisation of each stage in the backward (:class:`UNet`).
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        spatial_size: Sequence[int],
        encoder_depth: Sequence[int] = (1, 1, 1, 1, 1),
        encoder_width: Sequence[int] = (32, 64, 128, 256, 512),
        strides: Sequence[int] = (1, 2, 2, 2, 2),
        decoder_depth: Sequence[int] = (1, 1, 1, 1),
        mlp_ratio: float = 2,
        reshape: ReshapeSpec = DEFAULT_RESHAPE,
        act: str = "relu",
        rank: Optional[int] = None,
        num_iters: Optional[int] = None,
        num_grad_steps: Optional[int] = None,
        init_method: Optional[str] = None,
        solver: Optional[str] = None,
        factorize_options: Optional[dict[str, Any]] = None,
        norm: NormSpec = LayerNorm,
        factorize: Any = NMF,
        remat: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        fact_opts = dict(rank=rank, num_iters=num_iters, num_grad_steps=num_grad_steps,
                         init_method=init_method, solver=solver)
        factorize_kwargs = {k: v for k, v in fact_opts.items() if v is not None}
        bottleneck = len(encoder_depth) - 1

        def stage(i: int, cin: int, cout: int, depth: int, size: tuple) -> nn.Module:
            return FactorizerStage(
                cin, cout, size, depth, pos_embed=i == bottleneck, mlp_ratio=mlp_ratio,
                reshape=reshape, act=act, factorize_kwargs=factorize_kwargs, factorize_options=factorize_options,
                norm=norm, factorize=factorize, dtype=dtype, device=device, generator=generator,
            )

        super().__init__(
            in_channels, out_channels, spatial_size, encoder_depth, encoder_width, strides,
            decoder_depth, stage, dtype=dtype, device=device, generator=generator,
            spatial_dims=len(spatial_size), remat=remat,
        )
