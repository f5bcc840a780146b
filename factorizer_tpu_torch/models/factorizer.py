"""Factorizer models: factorization-mixing pre-norm blocks in a U-Net.

PyTorch counterpart of ``factorizer_tpu/models/factorizer.py``
(FactMixer -> FactorizerBlock -> FactorizerStage -> Factorizer), channels-last
inside, over 3-D volumes or 2-D images (``spatial_size`` of length 3 or 2).
Three kernels carry the blocks:

* ``FactMixer``, the windowed route: K1 (``ops.kernels.windowed_nmf``), which
  never materialises the fold, takes a mixer under the JAX package's rule for
  its fused windowed kernel (``_fused_fallback_reason`` without its TPU
  check): a channels-last 3-D (SW)Matricize with a head_dim and cubic patches
  that divide the volume, and a ``MatrixFactorization`` whose solver is the
  string ``"hals"`` or ``"mu"``, with no ``project``, a ``RandomInit`` and
  rank 1 (after the ``compression`` rule).
* ``FactMixer``, the flat route: every other mixer (2-D, rank above 1,
  non-cubic patches, an SVD or NNDSVD init, any other solver, ``SVD``) and
  every mixer under ``factorize_options={"use_windowed": False}`` runs fold ->
  factorize -> unfold, where a ``MatrixFactorization`` goes through K4
  (``ops.kernels.nmf_reconstruct``) under that kernel's rule
  (``MatrixFactorization.supports``), else through the stock ``decompose``
  chain (the default global ``Matricize``, the SVD paths, the other solvers).
  The two routes compute the same function where both apply.
  ``factorize_options={"use_pallas": False}`` is the JAX package's pure-XLA
  mode: neither K1 nor K4, every mixer on the ``decompose`` chain (the key
  reaches the ``MatrixFactorization`` through the keyword filter below).  A
  mixer off K1 logs why at INFO, in the JAX package's words
  (:meth:`FactMixer._fused_fallback_reason`): each distinct reason once, an
  explicit opt-out never, and every forward under ``{"explain": True}``.
  Only the configuration chooses these routes: no kernel that fails gives way
  to them, and no environment variable is read.
* ``FactMixer``, the split route: under ``factorize_options={"split_shifts":
  True}`` a flat-route mixer with an ``SWMatricize`` of more than one shift
  and a ``MatrixFactorization`` folds, factorizes (K4 under its rule) and
  unfolds once per shift and sums the results (``acc + z``, then ``/ n``), as
  the JAX package's does: the same values as the flat route, bit for bit,
  without the concatenated fold of every shift.  A mixer that K1 computes
  keeps K1 (the JAX package checks its fused kernel first).
* ``FactorizerBlock`` sends its tail ``x + mlp(norm2(x))`` through K2
  (``ops.kernels.prenorm_mlp``), reading the ``norm2`` and ``mlp`` parameters,
  where ``layers.basic.prenorm_mlp_reason`` allows it: a :class:`LayerNorm`
  (the default and the bundles' choice), K2's widths, and no active dropout;
  otherwise the tail is stock PyTorch, as ``DeconverBlock`` decides.

The bundles' ``network_def`` keys ``norm``, ``factorize``, ``compression``,
``pos_embed`` and ``remat`` are taken as the JAX model takes them, and so are
the skeleton's ``stem``, ``downsample``, ``upsample``, ``head``,
``num_deep_supr`` and ``data_format`` (:class:`~.unet.UNet`), ``dropout``
(after each mixer's ``out_proj``, at the MLP's two sites and after the
bottleneck's positional embedding; each process draws its own masks on slabs)
and the stage's ``adapter`` spec.
``factorize`` is any matrix factorizer spec (``NMF``, ``MatrixFactorization``,
``SVD``, ``(class, kwargs)``); ``factorize_options`` reach it as they reach the
JAX package's, filtered by the keywords its class accepts.

With ``factorize_options={"spatial_mesh": mesh, "spatial_axis": name}`` a
windowed mixer runs on a slab of the volume, cut along the first spatial axis
over that axis of the process mesh, through K5
(``ops.kernels.windowed_nmf_multi_spatial``: the slab kernels, a halo and
the routed factors); ``spatial_size`` stays the whole volume's.  Everything else in a
block is per voxel and needs nothing; a stage's positional embedding is cut
to the slab's rows.  The whole model runs on slabs under
``parallel.slabs.on_slabs`` (the spatial train step): there each windowed
mixer runs K5 on its slab, or gathers the stage's tensor, runs K1 on all of
it and cuts its slab back out (:meth:`FactMixer.gathers`: where the slab holds
no whole number of patches, or where gathering sends fewer bytes); a flat
mixer (K4, the 2-D model's, the split route too) runs on the gathered tensor;
a block norm of ``models.unet.SLAB_NORMS`` is per voxel or sums its statistics
over the slabs, and a stage with any other norm runs gathered with every
deeper level (``UNet.slab_route``), its mixers on K1.

in_proj, out_proj, the stage adapter, the folds, the dropouts and the
convolutions stay stock PyTorch.
"""

from __future__ import annotations

import logging
from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..factorization.inits import RandomInit
from ..factorization.nmf import NMF, MatrixFactorization, translate_mf_kwargs
from ..layers.basic import (
    ACTIVATIONS, Dropout, LayerNorm, Linear, MLP, NormSpec, build_norm, prenorm_mlp_tail,
)
from ..layers.pos_embed import PositionalEmbedding
from ..ops.kernels import windowed_nmf, windowed_nmf_multi_spatial
from ..ops.kernels.windowed_sharded import exchange_bytes
from ..ops.reshape import Matricize, SWMatricize
from ..parallel.slabs import Slabs
from ..utils.helpers import build_spec, has_args, partialize, spec_accepts
from .unet import CONV_STEM, SLAB_NORMS, UNet, build_block, slab_path_missing_of

__all__ = ["FactMixer", "FactorizerBlock", "FactorizerStage", "Factorizer"]

# Reshape spec: a class, or (class, keyword arguments) as the bundle configs write it.
ReshapeSpec = Any
DEFAULT_RESHAPE: ReshapeSpec = (Matricize, {"num_heads": 1, "grid_size": 1})
# The ``factorize_options`` keys that the mixer reads itself; every key goes to the factorizer too where its class
# takes it (``use_pallas`` to a ``MatrixFactorization``), as in the JAX package.
MIXER_OPTIONS = ("use_windowed", "use_pallas", "explain", "split_shifts", "spatial_mesh", "spatial_axis")
DEFAULT_ADAPTER = (Linear, {"bias": False})
logger = logging.getLogger(__name__)
# The reasons logged so far in this process: each is logged once, as the JAX package logs them (``explain`` logs
# every forward).
_LOGGED_FALLBACKS: set[str] = set()


def _spatial_option(factorize_options: Optional[dict]) -> Optional[tuple]:
    """``(mesh, axis)`` when the options cut the volume's first spatial axis over a mesh axis, else None."""
    mesh = (factorize_options or {}).get("spatial_mesh")
    if mesh is None:
        return None
    axis = factorize_options.get("spatial_axis", "model")
    mesh.axis_size(axis)  # raises on an axis the mesh lacks
    return mesh, axis


def _slabs(module: nn.Module) -> Optional[Slabs]:
    """The slabs a module runs on: those of ``on_slabs``, else those of its ``spatial_mesh`` option, else None."""
    if module.slabs is not None:
        return module.slabs
    return None if module.spatial is None else Slabs(*module.spatial)


class FactMixer(nn.Module):
    """Token mixing: project -> act -> fold -> factorize -> unfold -> project.

    ``factorize`` is the factorizer spec (:class:`NMF` by default,
    ``MatrixFactorization``, ``SVD``, ``(class, kwargs)``); it is built with
    the folded matrices' size and the entries of ``factorize_kwargs`` (the
    model's ``rank``, ``compression``, ``num_iters``, ``num_grad_steps``,
    ``init_method``, ``solver``) and of ``factorize_options`` that its class
    takes, ``factorize_options`` first, ``init`` read as ``init_method``.
    ``factorize_options={"split_shifts": True}`` runs a flat-route mixer with
    an ``SWMatricize`` of several shifts and a ``MatrixFactorization`` once per
    shift (:attr:`splits_shifts`).  ``dropout`` follows ``out_proj``.
    ``factorize_options={"use_windowed": False}`` takes a mixer that K1 would
    compute to the flat route instead (fold -> NMF -> unfold, K4).  It is the
    JAX package's opt-out, kept so that its configurations carry over and so
    that the two routes can be held against each other; on one card the flat
    route is the slower one and needs more memory (it copies the tensor for
    every shift), so no single-card deployment should set it.
    ``factorize_options={"use_pallas": False}``, JAX's pure-XLA mode, takes
    the flat route too and keeps the factorizer off K4 (its ``use_pallas``).
    :attr:`fallback_reason` says why a mixer is off K1 (None: on K1); the
    forward logs it as JAX's does, every time under ``{"explain": True}``.
    ``factorize_options={"spatial_mesh": mesh, "spatial_axis": "model"}``:
    ``forward`` takes this process's slab ``(B, S1 / n, S2, S3, C)`` of the
    volume, one of equal slabs, and mixes it through K5; only a mixer that K1
    computes can, and each slab must hold whole windows.  Under
    ``parallel.slabs.on_slabs`` (``slabs`` set) ``forward`` takes a slab of
    the line's cut, of any row count and equal to the others' or not, and
    :meth:`gathers` chooses K5 or K1 on the gathered tensor from every slab's
    rows; the flat route runs on the gathered tensor (K4 on the whole, on
    every process).
    """

    # This process's parallel.slabs.Slabs while the model runs on slabs, else None.
    slabs = None

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
        dropout: float = 0.0,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        fact_fn = partialize(factorize)
        if not has_args(fact_fn, "size"):
            name = getattr(getattr(fact_fn, "func", fact_fn), "__name__", repr(factorize))
            raise NotImplementedError(f"factorize={name} is no matrix factorizer (a class taking the matrices' size): "
                                      "the Factorizer takes NMF, MatrixFactorization, SVD or another such class")
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.in_proj = Linear(in_channels, out_channels, bias=False, **kw)
        reshape_kwargs = {}
        if spec_accepts(reshape, "data_format"):
            reshape_kwargs["data_format"] = "channels_last"
        self.reshape = partialize(reshape)((None, *spatial_size, out_channels), **reshape_kwargs)
        self.act = ACTIVATIONS[act]
        options = dict(factorize_options or {})
        for key, value in (factorize_kwargs or {}).items():
            if value is not None:
                options.setdefault(key, value)
        options = translate_mf_kwargs(options)
        options = {k: v for k, v in options.items()
                   if k not in ("device", "generator") and (spec_accepts(factorize, k) or has_args(fact_fn, k))}
        self.factorize = build_spec(factorize, tuple(self.reshape.output_size[2:]),
                                    context={"device": device, "generator": generator}, **options)
        self.out_proj = Linear(out_channels, out_channels, bias=True, **kw)
        self.drop = Dropout(dropout)
        opts = factorize_options or {}
        self.explain = bool(opts.get("explain"))
        self.opted_out = opts.get("use_windowed") is False or opts.get("use_pallas") is False
        self.fallback_reason = self._fused_fallback_reason(tuple(spatial_size), out_channels, opts)
        self.windowed = None if self.fallback_reason else self._windowed_config()
        self.splits_shifts = self.windowed is None and self._split_shift_eligible(factorize_options)
        self.spatial = _spatial_option(factorize_options)
        if self.spatial is not None:
            if self.windowed is None:
                raise ValueError(
                    "factorize_options['spatial_mesh'] needs a mixer that the windowed kernel computes (3-D, a head_dim, "
                    "cubic patches, rank-1 hals or mu from a RandomInit, use_windowed and use_pallas not False): the flat "
                    f"route has no sharded form ({self.fallback_reason})"
                )
            mesh, axis = self.spatial
            n, patch = mesh.axis_size(axis), self.windowed[1]
            if spatial_size[0] % n or (spatial_size[0] // n) % patch:
                raise ValueError(
                    f"spatial_mesh: {spatial_size[0]} rows over {n} processes of axis {axis!r} do not give slabs of a "
                    f"whole number of patches of {patch}"
                )
            self.slab_rows = spatial_size[0] // n

    def _fused_fallback_reason(self, spatial_size: tuple, channels: int, options: dict) -> Optional[str]:
        """Why K1 does not compute this mixer, in the JAX package's words (its ``_fused_fallback_reason``), or None.

        JAX's last check, "not on TPU", has no counterpart: the port's route is
        chosen by configuration, never by platform.  The same string for the
        same configuration, since ``explain`` logs it."""
        if options.get("use_windowed") is False:
            return "factorize_options['use_windowed'] is False (explicit opt-out)"
        if options.get("use_pallas") is False:
            return "factorize_options['use_pallas'] is False (pure-XLA mode)"
        fact = self.factorize
        mats = (self.reshape.shifted_windows if isinstance(self.reshape, SWMatricize)
                else [self.reshape] if isinstance(self.reshape, Matricize) else None)
        if not isinstance(fact, MatrixFactorization):
            return "factorize op is not a MatrixFactorization"
        if len(spatial_size) != 3:
            return "kernel requires a 3-D volume (2-D configs use the flat path)"
        ax = {} if mats is None else mats[0].axis_sizes
        d, ps = ax.get("d"), [ax.get(f"p{i}") for i in range(3)]
        if mats is None or mats[0].data_format != "channels_last" or d is None or ps[0] is None or ps.count(ps[0]) != 3:
            return "reshape is not a channels-last (SW)Matricize with cubic patches (p0 == p1 == p2) and a head_dim"
        if not isinstance(fact.solver, str):
            return "composite/custom solver objects are outside kernel coverage"
        if fact.project is not None:
            return "solver with a projection step is outside kernel coverage"
        if not isinstance(fact.init, RandomInit):
            return "kernel covers RandomInit initializers only (svd/nndsvd fall back)"
        if fact.rank_ != 1:
            return f"kernel covers rank 1 only (rank={fact.rank_})"
        if fact.solver not in ("hals", "mu"):
            return f"kernel covers hals/mu solvers only (solver={fact.solver!r})"
        if channels % d:
            return f"channels {channels} not divisible by head_dim {d}"
        if any(s % ps[0] for s in spatial_size):
            return f"spatial size {tuple(spatial_size)} not divisible by patch_size {ps[0]}"
        return None

    def _windowed_config(self) -> tuple[int, int, tuple]:
        """``(head_dim, patch, shifts)`` of a mixer that K1 computes."""
        mats = self.reshape.shifted_windows if isinstance(self.reshape, SWMatricize) else [self.reshape]
        return mats[0].axis_sizes["d"], mats[0].axis_sizes["p0"], tuple(m.shifts for m in mats)

    def _explain(self) -> None:
        """Log why this mixer takes the flat route, at INFO, as the JAX package's ``_use_fused_windowed`` does: each
        distinct reason once per process, every forward under ``factorize_options={"explain": True}``, never an
        explicit opt-out (``use_windowed`` or ``use_pallas`` False) unless explained."""
        reason = self.fallback_reason
        if self.explain or (not self.opted_out and reason not in _LOGGED_FALLBACKS):
            _LOGGED_FALLBACKS.add(reason)
            logger.info("FactMixer falls back to the unfused factorization path: %s", reason)

    def _split_shift_eligible(self, factorize_options: Optional[dict]) -> bool:
        """Whether the flat route runs once per shift: ``split_shifts`` asked for, an ``SWMatricize`` of more than one
        shift and a ``MatrixFactorization`` (which treats each matrix on its own), the JAX package's rule.  The sum
        over shifts then skips the concatenated fold of every shift, which halves the mixer's peak activations."""
        return (
            bool((factorize_options or {}).get("split_shifts"))
            and isinstance(self.reshape, SWMatricize)
            and len(self.reshape.shifted_windows) > 1
            and isinstance(self.factorize, MatrixFactorization)
        )

    def _flat(self, out: torch.Tensor) -> torch.Tensor:
        """fold -> factorize -> unfold of the activated tensor: once per shift under :attr:`splits_shifts`, summed in
        the JAX package's order (``acc + z``, then ``/ n``), else over the concatenated folds.  Logs why the mixer is
        off K1 (:meth:`_explain`)."""
        self._explain()
        if not self.splits_shifts:
            return self.reshape.inverse_forward(self.factorize(self.reshape.forward(out)))
        acc = None
        for m in self.reshape.shifted_windows:
            z = m.inverse_forward(self.factorize(m.forward(out)))
            acc = z if acc is None else acc + z
        return acc / len(self.reshape.shifted_windows)

    def gathers(self, x: torch.Tensor) -> bool:
        """Whether this process's slab ``x`` is gathered around K1 instead of running K5 (the spatial step's one rule).

        Judged from the line's slabs, never from this one alone, so that no
        process enters K5's ring while another gathers.  Gathered where some
        slab holds no whole number of patches, or where the all-gather and its
        backward send fewer bytes than K5's exchanges would.  Per process K5
        sends, in a forward and its backward, the last ``H`` rows of its slab
        three times (``H`` the largest ``s1``: x in the forward, x and its
        cotangent in the backward, in the slab's dtype), the forward's routed
        factors and the backward's routed rows (``s1`` rows a shift), both in
        f32 (``ops.kernels.windowed_sharded.exchange_bytes``); the gather sends
        a slab of the mean rows to each of the ``n - 1`` others, forward and
        backward.  In f32 on 2 and 4 slabs that runs K5 on the stages of side
        32 and more in ``factorizer_brats23`` and of side 16 and more in
        ``factorizer_isles22``, and gathers the others.  Both routes give the
        same values (K5 equals K1 bit for bit on the card): the rule moves
        time and memory only.
        """
        head_dim, patch, shifts = self.windowed
        slabs = self.slabs
        whole = slabs.whole_rows(x.shape[1])
        if any(rows % patch for rows in slabs.cut.sizes(whole)):
            return True
        row_bytes = x.numel() // x.shape[1] * x.element_size()
        k5 = exchange_bytes(x.shape, x.element_size(), head_dim, patch, shifts)
        return 2 * (slabs.n - 1) * whole * row_bytes < slabs.n * k5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.act(self.in_proj(x))  # elementwise, so it commutes with the fold
        if self.windowed is not None:
            fact = self.factorize
            config = (fact.init.u0, fact.init.v0, *self.windowed, fact.solver, fact.num_iters, fact.kernel_eps,
                      fact.num_grad_steps)
            slabs = _slabs(self)
            if slabs is None:
                out = windowed_nmf(out, *config)
            elif self.slabs is not None and self.gathers(out):
                out = slabs.cut_slab(windowed_nmf(slabs.gather_slabs(out), *config))
            else:
                if self.slabs is None and out.shape[1] != self.slab_rows:
                    raise ValueError(f"spatial_mesh: expected a slab of {self.slab_rows} rows, got shape {tuple(out.shape)}")
                out = windowed_nmf_multi_spatial(out, *config, mesh=slabs.mesh, axis_name=slabs.axis)
        elif self.slabs is not None:  # the flat route on the gathered tensor, on every process
            once = next(self.factorize.parameters(), None) is not None
            out = self.slabs.cut_slab(self._flat(self.slabs.gather_slabs(out, count_once=once)), count_once=once)
        else:
            out = self._flat(out)
        return self.drop(self.out_proj(out))


class FactorizerBlock(nn.Module):
    """Pre-norm residual block: ``x + fact(norm1(x))``, then ``x + mlp(norm2(x))`` (K2 where
    ``prenorm_mlp_reason`` allows it); ``dropout`` goes to the mixer and both of the MLP's sites."""

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
        dropout: float = 0.0,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.norm1 = build_norm(norm, channels, dtype, device)
        self.fact = FactMixer(channels, channels, spatial_size, reshape, act, factorize_kwargs, factorize_options,
                              factorize, dropout=dropout, dtype=dtype, device=device, generator=generator)
        self.norm2 = build_norm(norm, channels, dtype, device)
        self.mlp = MLP(channels, ratio=mlp_ratio, dropout=dropout, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.fact(self.norm1(x))
        return prenorm_mlp_tail(self.norm2, self.mlp, x)


class FactorizerStage(nn.Module):
    """One resolution stage: channel adapter, optional positional embedding and its dropout, ``depth`` blocks.

    ``adapter`` is the spec of the channel adapter, built where the widths
    differ (``(Linear, {"bias": False})`` by default, as in the JAX model).

    ``pos_embed`` is an embedding spec (``PositionalEmbedding``,
    ``SinusoidalPositionalEmbedding``, ``RotaryPositionalEmbedding``,
    ``AxialPositionalEmbedding``, ``(class, kwargs)``) built with the width and
    the stage's size, or None; ``True`` means ``PositionalEmbedding``.  Under
    ``factorize_options["spatial_mesh"]``, or with ``slabs`` set, the stage runs
    on a slab and adds the slab's rows of the embedding.
    """

    # This process's parallel.slabs.Slabs while the model runs on slabs, else None.
    slabs = None

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        spatial_size: Sequence[int],
        depth: int = 1,
        adapter: Any = DEFAULT_ADAPTER,
        pos_embed: Any = None,
        dropout: float = 0.0,
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
        if pos_embed is True:
            pos_embed = PositionalEmbedding
        self.pos_embed = (
            build_spec(pos_embed, out_channels, tuple(spatial_size), context={"device": device, "generator": generator})
            if pos_embed not in (None, False)
            else None
        )
        self.pos_drop = Dropout(dropout) if self.pos_embed is not None else None
        self.spatial = _spatial_option(block_kwargs.get("factorize_options"))
        self.blocks = nn.ModuleList(
            FactorizerBlock(out_channels, spatial_size, dropout=dropout, **block_kwargs, **kw) for _ in range(depth)
        )

    def slab_path_missing(self) -> Optional[str]:
        """What keeps the stage from running on slabs, or None (the model's route then gathers it): a block norm
        outside ``SLAB_NORMS`` (per voxel, or statistics summed over the slabs), or an adapter without a known slab
        path."""
        for i, blk in enumerate(self.blocks):
            for name in ("norm1", "norm2"):
                norm = getattr(blk, name)
                if not isinstance(norm, SLAB_NORMS):
                    return (f"{type(norm).__name__} (blocks.{i}.{name}) is not one of the norms with a slab path "
                            f"({', '.join(sorted({c.__name__ for c in SLAB_NORMS}))})")
        return None if self.adapter is None else slab_path_missing_of(self.adapter, "adapter")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.adapter is not None:
            x = self.adapter(x)
        if self.pos_embed is not None:
            rows, slabs = None, _slabs(self)
            if slabs is not None:  # x is this process's slab of the volume
                first = slabs.offset(x.shape[1])
                rows = slice(first, first + x.shape[1])
            x = self.pos_drop(self.pos_embed(x, rows))
        for blk in self.blocks:
            x = blk(x)
        return x


class Factorizer(UNet):
    """Swin-Factorizer segmentation U-Net; the bottleneck stage carries the positional embedding ``pos_embed``.

    A :class:`UNet` whose stage blocks are :class:`FactorizerStage`, with the
    JAX model's default stem ``(Conv, {"kernel_size": 3, "padding": 1,
    "bias": False})``.  Factorization options left at None take the
    factorizer's defaults, as in the JAX model.  ``spatial_size`` of length 2
    builds the 2-D model, whose mixers take the flat route;
    ``factorize_options`` goes to every :class:`FactMixer`.  ``norm``,
    ``factorize``, ``compression``, ``pos_embed`` and ``remat`` are the
    bundles' keys of the same names: the blocks' norm, the factorizer spec,
    the auto-rank rule's target when ``rank`` is None, the bottleneck's
    embedding spec (None: none), and rematerialisation of each stage in the
    backward.  ``stem``, ``downsample``, ``upsample``, ``head``,
    ``num_deep_supr`` and ``data_format`` go to the :class:`UNet`,
    ``dropout`` to every stage.
    """

    flax_prefix = "unet."

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        spatial_size: Sequence[int],
        encoder_depth: Sequence[int] = (1, 1, 1, 1, 1),
        encoder_width: Sequence[int] = (32, 64, 128, 256, 512),
        strides: Sequence[int] = (1, 2, 2, 2, 2),
        decoder_depth: Sequence[int] = (1, 1, 1, 1),
        stem: Any = None,
        downsample: Any = None,
        upsample: Any = None,
        head: Any = None,
        pos_embed: Any = PositionalEmbedding,
        num_deep_supr: Any = False,
        data_format: str = "channels_first",
        norm: NormSpec = LayerNorm,
        dropout: float = 0.0,
        mlp_ratio: float = 2,
        reshape: ReshapeSpec = DEFAULT_RESHAPE,
        act: str = "relu",
        factorize: Any = NMF,
        rank: Optional[int] = None,
        compression: Optional[float] = None,
        num_iters: Optional[int] = None,
        num_grad_steps: Optional[int] = None,
        init_method: Any = None,
        solver: Any = None,
        factorize_options: Optional[dict[str, Any]] = None,
        remat: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        fact_opts = dict(rank=rank, compression=compression, num_iters=num_iters, num_grad_steps=num_grad_steps,
                         init_method=init_method, solver=solver)
        block_kwargs = dict(
            dropout=dropout, mlp_ratio=mlp_ratio, reshape=reshape, act=act,
            factorize_kwargs={k: v for k, v in fact_opts.items() if v is not None},
            factorize_options=factorize_options, norm=norm, factorize=factorize,
        )
        n_enc, n_dec = len(encoder_depth), len(decoder_depth)
        blocks = ((n_enc - 1) * [(FactorizerStage, block_kwargs)]
                  + [(FactorizerStage, {"pos_embed": pos_embed, **block_kwargs})]
                  + n_dec * [(FactorizerStage, block_kwargs)])
        super().__init__(
            in_channels, out_channels, spatial_size, encoder_depth, encoder_width, strides, decoder_depth,
            stem=CONV_STEM if stem is None else stem, downsample=downsample, block=blocks, upsample=upsample,
            head=head, num_deep_supr=num_deep_supr, data_format=data_format, dtype=dtype, device=device,
            generator=generator, spatial_dims=len(spatial_size), remat=remat,
        )
