"""A model run on slabs of its input: the first spatial axis cut over one axis of the process mesh.

The port's counterpart of what GSPMD does for the JAX package's spatial
train step (``factorizer_tpu/train/trainer.py:106,200`` constrains the
input's first spatial axis over ``model``; ``ops/pallas/partitioning.py``
gathers each Pallas kernel's operands).  Here nothing is inferred: the layers
that have a slab path read this process's :class:`Slabs` from their
``slabs`` attribute, which :func:`on_slabs` sets on them for the time of a
forward and its backward, and otherwise run as they always do:

* ``layers.basic``: ``Conv`` with a kernel wider than 1 along the cut axis
  exchanges a halo of its padding rows (:func:`~.collectives.halo_exchange`)
  and pads none there; ``ConvTranspose`` with a kernel equal to its stride and
  the pointwise convolutions are local; ``InstanceNorm``, ``GroupNorm`` and
  ``FlaxGroupNorm`` take the whole volume's statistics
  (:func:`~.collectives.slab_sum`, whose backward sums the cotangent over the
  slabs); LayerNorm is per voxel.  Each layer states the rows it needs
  (``slab_rows_missing``): a stride-s convolution a row count that s divides,
  a halo no wider than the slab;
* ``Deconv`` (the Deconver): each of the source update's three convolutions
  runs K3 on its slab and a halo of ``k1 // 2`` rows, cropped back; the filter
  update (``update_filter``) sums each slab's partial correlations
  (``slab_sum``), so the filter stays equal on every process;
* ``SegResNet``'s linear upsampling resizes a one-row halo that repeats the
  volume's edge rows (``edge="replicate"``);
* ``SwinUNETR`` and ``UNETR``: the transformer on the gathered tensor, V2's
  stage convolutions inside it as on one process;
* ``FactorizerStage``: this slab's rows of the positional embedding;
* ``FactMixer``: K5 (``ops.kernels.windowed_nmf_multi_spatial``) on the
  slab, or the stage's tensor gathered, K1 on the whole of it and this slab
  cut back out where the slab holds no whole number of patches or gathering
  sends fewer bytes (``FactMixer.gathers``);
* the block tails (K2), the projections and ``Dropout`` are per voxel (each
  process draws its own mask for its slab).

**The gathered route.**  What has no slab path, or whose slab holds too few
rows, runs whole on every process of the line (:func:`run_gathered`): its
input gathered (:func:`~.collectives.gather_slabs` with ``count_once``), its
layers with ``slabs`` cleared (a ``Conv`` pads as on one process, a norm takes
its local statistics, a ``FactMixer`` runs K1), its outputs cut back
(:func:`~.collectives.cut_slab`, ``count_once``: every process computes the
part's whole parameter gradient, so the step's sum over the slabs counts it
once).  A dropout inside draws one mask on every process (a seed broadcast
from the line's first process), and a rematerialised block recomputes as it
ran (:func:`as_now`).  Each model chooses by one rule before its forward,
``slab_route(rows, n)`` (a :class:`Route`): the U-shaped models run their
levels on slabs down to the first level ℓ whose part has no slab path or whose
slab rows do not suffice, and the levels from ℓ down to the bottleneck and back
up to ℓ gathered (:func:`run_ladder`); ℓ = 0 is the whole model gathered,
which saves no memory.  The transformers' trunk is always gathered.

What stays refused: an input whose rows do not cut into equal slabs
(``cut_slab``), and a deep-supervision head whose level's rows do not cut into
the slabs.  A model tells what it lacks through ``slab_path_missing()`` (a
reason, or None); a model without the method has no slab path.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Sequence

import torch
from torch import nn

from .collectives import broadcast_from_first, cut_slab, gather_slabs
from .mesh import Mesh

__all__ = ["Slabs", "Route", "on_slabs", "off_slabs", "require_slab_path", "slab_route", "run_gathered", "run_whole",
           "run_ladder", "as_now"]


@dataclass(frozen=True)
class Slabs:
    """This process's slab: the ``index``-th of ``n`` equal parts of the first spatial axis, over ``axis`` of ``mesh``."""

    mesh: Mesh
    axis: str = "model"

    @property
    def n(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def index(self) -> int:
        return self.mesh.axis_index(self.axis)


@dataclass(frozen=True)
class Route:
    """How a model runs on slabs of a given row count: ``level`` is the first level (0 the finest) that runs gathered,
    with every deeper one; 0 is the whole model, None none of its levels.  ``reason`` names the part that decided."""

    level: Optional[int] = None
    reason: str = ""

    def __str__(self) -> str:
        if self.level is None:
            return "every level on slabs" + (f" ({self.reason})" if self.reason else "")
        if self.level == 0:
            return f"whole model gathered, no memory saving: {self.reason}"
        return f"levels {self.level} and deeper gathered: {self.reason}"


def require_slab_path(model: nn.Module) -> None:
    """Raise ``NotImplementedError`` naming what ``model`` lacks to run on slabs; return if it has a slab path."""
    missing = getattr(model, "slab_path_missing", None)
    reason = f"{type(model).__name__} has no slab path" if missing is None else missing()
    if reason is not None:
        raise NotImplementedError(f"the spatial step (spatial_axis, shard_spatial) is not ported for this model: {reason}")


def slab_route(model: nn.Module, rows: int, n: int) -> Route:
    """The route ``model`` takes on ``n`` slabs of ``rows`` rows (its ``slab_route``; a model without one runs every
    layer on its slab)."""
    rule = getattr(model, "slab_route", None)
    return Route() if rule is None else rule(rows, n)


@contextlib.contextmanager
def on_slabs(model: nn.Module, slabs: Slabs) -> Iterator[nn.Module]:
    """Within the block, ``model`` takes and returns this process's slab ``(B, C, S1 / n, S2, S3)`` of its input.

    Run the backward inside the block too: a rematerialised stage runs its
    forward again there.  Raises first if the model has no slab path.
    """
    require_slab_path(model)
    holders = [m for m in model.modules() if hasattr(m, "slabs")]
    for m in holders:
        m.slabs = slabs
    try:
        yield model
    finally:
        for m in holders:
            m.slabs = None


@contextlib.contextmanager
def off_slabs(*modules: nn.Module) -> Iterator[None]:
    """Within the block the layers of ``modules`` run as on one process (``slabs`` cleared); restored after it."""
    held = [(m, m.slabs) for module in modules for m in module.modules() if getattr(m, "slabs", None) is not None]
    for m, _ in held:
        m.slabs = None
    try:
        yield
    finally:
        for m, slabs in held:
            m.slabs = slabs


def as_now(module: nn.Module) -> Callable:
    """``module``'s forward as a function that runs with the slabs its layers hold now whenever it is called: a
    checkpointed block's recompute in the backward then runs as its forward did, on slabs or gathered."""
    state = [(m, m.slabs) for m in module.modules() if hasattr(m, "slabs")]

    def run(*args: Any) -> Any:
        saved = [(m, m.slabs) for m, _ in state]
        for m, slabs in state:
            m.slabs = slabs
        try:
            return module(*args)
        finally:
            for m, slabs in saved:
                m.slabs = slabs

    return run


@contextlib.contextmanager
def _same_draws(modules: Sequence[nn.Module], slabs: Slabs, like: torch.Tensor) -> Iterator[None]:
    """Within the block every process of the line draws the same random numbers, where a dropout of ``modules`` is
    active: a seed broadcast from the line's first process, on a forked generator (the caller's stream resumes after
    the block)."""
    active = any(isinstance(m, nn.Dropout) and m.training and m.p > 0 for module in modules for m in module.modules())
    if not active:
        yield
        return
    seed = broadcast_from_first(torch.randint(2**62, (1,), device=like.device), slabs.mesh, slabs.axis)
    with torch.random.fork_rng(devices=[like.device] if like.is_cuda else []):
        torch.manual_seed(int(seed.item()))
        yield


def run_gathered(fn: Callable, modules: Sequence[nn.Module], slabs: Slabs, *xs: torch.Tensor, dim: int = 1) -> Any:
    """``fn`` on the whole tensors of the slabs ``xs`` (cut along ``dim``), on every process of the line alike, with
    ``slabs`` cleared on the layers of ``modules``; returns ``fn``'s whole outputs, which the caller cuts back with
    ``cut_slab(..., count_once=True)``.  Collective over the line."""
    whole = [gather_slabs(x, slabs.mesh, slabs.axis, dim=dim, count_once=True) for x in xs]
    with off_slabs(*modules), _same_draws(modules, slabs, whole[0]):
        return fn(*whole)


def _cutter(slabs: Slabs, dim: int = 1) -> Callable:
    return lambda t: cut_slab(t, slabs.mesh, slabs.axis, dim, count_once=True)


def run_whole(model: nn.Module, x: torch.Tensor, slabs: Slabs, dim: int) -> Any:
    """The route ℓ = 0: ``model`` on the whole input, gathered along ``dim``, on every process; its output (a tensor or
    a list of them) cut back along the same ``dim``."""
    out = run_gathered(model, [model], slabs, x, dim=dim)
    cut = _cutter(slabs, dim)
    return [cut(t) for t in out] if isinstance(out, (list, tuple)) else cut(out)


def run_ladder(x: torch.Tensor, down: Sequence[Callable], up: dict, merge: dict, keep: Sequence[int] = (),
               level: Optional[int] = None, slabs: Optional[Slabs] = None,
               modules: Sequence[nn.Module] = ()) -> dict[int, torch.Tensor]:
    """The U-shaped pass, channels-last, on this process's slab down to ``level`` and gathered from it.

    ``down[l](t)``: the encoder's level ``l`` from level ``l - 1`` (``x`` is
    level -1); the last is the bottleneck.  ``up[l](d)``: level ``l + 1``'s
    decoder output up to level ``l``; ``merge[l](skip, u)``: the decoder output
    at level ``l`` from the encoder's and ``u``, for each level the decoder
    reaches (the keys of ``merge``).  Returns each level's output for the levels
    in ``keep`` and the finest the decoder reaches: the decoder's where it
    reaches the level, else the encoder's.

    ``level`` (at least 1, with ``slabs``): levels ``level`` and deeper run in
    one gathered part (:func:`run_gathered` over ``modules``), from the
    encoder's level ``level - 1`` to ``up[level - 1]``'s output, and the
    outputs cut back; the others run on the slab.  None: every level as it is.
    """
    n_levels = len(down)
    finest = min(merge, default=n_levels - 1)
    want = sorted(set(keep) | {finest})
    first = n_levels if level is None else level

    def encode(t: torch.Tensor, lo: int, hi: int, outs: dict) -> torch.Tensor:
        for lv in range(lo, hi):
            t = outs[lv] = down[lv](t)
        return t

    def decode(d: torch.Tensor, lo: int, hi: int, skips: dict, outs: dict) -> torch.Tensor:
        for lv in range(hi, lo - 1, -1):
            d = outs[lv] = merge[lv](skips[lv], up[lv](d))
        return d

    skips: dict = {}
    encode(x, 0, first, skips)
    outs = dict(skips)
    if level is None:
        decode(skips[n_levels - 1], finest, n_levels - 2, skips, outs)
        return {lv: outs[lv] for lv in want}

    def tail(t: torch.Tensor) -> list:
        deep: dict = {}
        d = encode(t, level, n_levels, deep)
        whole = dict(deep)
        d = decode(d, max(level, finest), n_levels - 2, deep, whole)
        return [whole[lv] for lv in want if lv >= level] + ([up[level - 1](d)] if level - 1 >= finest else [])

    gathered = run_gathered(tail, modules, slabs, skips[level - 1])
    cut = _cutter(slabs)
    deep_levels = [lv for lv in want if lv >= level]
    outs.update({lv: cut(t) for lv, t in zip(deep_levels, gathered)})
    if level - 1 >= finest:
        d = outs[level - 1] = merge[level - 1](skips[level - 1], cut(gathered[-1]))
        decode(d, finest, level - 2, skips, outs)
    return {lv: outs[lv] for lv in want}
