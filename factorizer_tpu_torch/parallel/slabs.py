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
``slab_route(cut)`` (a :class:`Route`): the U-shaped models run their
levels on slabs down to the first level ℓ whose part has no slab path or whose
slab rows do not suffice, and the levels from ℓ down to the bottleneck and back
up to ℓ gathered (:func:`run_ladder`); ℓ = 0 is the whole model gathered,
which saves no memory.  The transformers' trunk is always gathered.

**The cut.**  One rule (:func:`choose_cut`) chooses the line's cut before the
forward, from three things only: the input's rows R, the slab count n and the
model's strides along the cut axis (its ``slab_strides``, input first).  So
every process of the line holds the same :class:`Cut`, and every route rule
judges every slab's rows from it, never from its own slab alone: with slabs
of unequal rows, two processes that chose apart would wait in different
collectives.

* Where n divides R, the slabs are equal, R / n rows each.
* Otherwise they lie on a grid of U rows, U the longest product of the
  strides (from the input's) that divides R into at least n grid rows: every
  slab then stays whole at each level whose strides U holds, and the levels
  below it run gathered by the model's route (:func:`run_ladder`).  The R / U
  grid rows go round near-equal, the first ``(R / U) mod n`` slabs one more.
  A longer product keeps more levels on slabs, and a gathered level costs
  every process the whole level, so one more level outweighs a few rows of
  balance.
* More slabs than rows (n > R, as JAX's GSPMD pads such a shard): R slabs of
  one row and n - R empty slabs (parts 0).  Every model's route runs such a
  cut whole-gathered (ℓ = 0, :func:`run_whole`, :func:`empty_route`), so the
  empty slabs take part in the gathers, the cut back and the loss's sums
  with no row, and nothing is saved.

For ``factorizer_brats23`` (128 rows, strides 1, 1, 2, 2, 2, 2 with the stem's,
so U = 16):

=====  ==========================
n      slab rows at the input
=====  ==========================
2, 4   64 / 64; 32 each (equal)
3      48 / 48 / 32
5      32 / 32 / 32 / 16 / 16
6      32 / 32 / 16 / 16 / 16 / 16
7      32 / 16 x 6
=====  ==========================

A tensor of W rows at any level cuts in the input's proportion (slab i holds
``W * parts[i] / sum(parts)`` of them, :meth:`Cut.sizes`): the gathers pad
each slab to the largest and trim it (:meth:`Slabs.gather_slabs`, through
:func:`~.collectives.all_gather_cat` with ``sizes``), the cuts take each
slab's offset (:meth:`Slabs.cut_slab`), and a norm's or the loss's count
takes the whole volume's rows.  Equal slabs are the cut whose parts are all 1,
and take the same code.  ``count_once`` stays ``1 / n``: every process computes the
gathered part's whole gradient, whatever its slab's rows.

A level below the grid, whose rows the cut does not keep whole on every slab,
runs gathered by the route.  Its output, where a deep-supervision head reads
it, is not cut back: the head runs in the gathered part and every process
returns the head's whole output (:func:`whole_on_slabs`, its cotangent
scaled by ``1 / n`` so that the sum over the slabs counts its gradient once),
and ``train.losses.deep_supervision_loss`` takes that head's term whole,
against the gathered target.  A model tells what it lacks through
``slab_path_missing()`` (a reason, or None); a model without the method has no
slab path.
"""

from __future__ import annotations

import contextlib
import itertools
import operator
from dataclasses import dataclass
from fractions import Fraction
from typing import Any, Callable, Iterator, Optional, Sequence, Union

import torch
from torch import nn

from .collectives import broadcast_from_first, count_once, cut_slab, gather_slabs
from .mesh import Mesh

__all__ = ["Cut", "choose_cut", "Slabs", "Route", "empty_route", "on_slabs", "off_slabs", "require_slab_path",
           "slab_cut", "slab_route", "run_gathered", "run_whole", "run_ladder", "as_now", "whole_on_slabs", "is_whole"]


@dataclass(frozen=True)
class Cut:
    """The line's cut of an input of ``rows`` rows along its first spatial axis: slab ``i`` (in axis order) holds the
    share ``parts[i] / sum(parts)`` of them, ``parts[i]`` grid rows (:func:`choose_cut`).

    A tensor of ``whole`` rows along the cut axis, at any level, cuts in the
    same proportion (:meth:`shares`, :meth:`sizes`, :meth:`offsets`).  The
    equal cut has every part 1; a cut of more slabs than rows has parts 0
    (empty slabs).
    """

    rows: int
    parts: tuple[int, ...]

    @classmethod
    def equal(cls, rows: int, n: int) -> "Cut":
        """``n`` equal slabs of ``rows / n`` rows (``n`` must divide ``rows``)."""
        if n < 1 or rows % n:
            raise ValueError(f"slabs: {rows} rows do not cut into {n} equal slabs")
        return cls(rows, (1,) * n)

    @property
    def n(self) -> int:
        return len(self.parts)

    @property
    def is_equal(self) -> bool:
        return len(set(self.parts)) == 1

    def shares(self, whole: Union[int, Fraction]) -> list[Fraction]:
        """Each slab's rows of a tensor of ``whole`` rows along the cut axis, in axis order (a fraction where the cut
        does not keep the tensor whole on that slab)."""
        total = sum(self.parts)
        return [Fraction(whole) * p / total for p in self.parts]

    def sizes(self, whole: int) -> list[int]:
        """Each slab's rows of a tensor of ``whole`` rows; raises where a slab would hold no whole number of them."""
        if not self.keeps(whole):
            raise ValueError(f"slabs: a tensor of {whole} rows does not cut into the slabs {self.describe()}")
        return [int(r) for r in self.shares(whole)]

    def keeps(self, whole: int) -> bool:
        """Whether a tensor of ``whole`` rows cuts into whole rows on every slab."""
        return all(r.denominator == 1 for r in self.shares(whole))

    @property
    def empty(self) -> int:
        """The count of slabs without a row (more slabs than rows)."""
        return self.parts.count(0)

    def offsets(self, whole: int) -> list[int]:
        """Each slab's first row in a tensor of ``whole`` rows."""
        return list(itertools.accumulate(self.sizes(whole)[:-1], initial=0))

    def describe(self) -> str:
        """The slab rows at the input: ``48 / 48 / 32``, or ``64`` for equal slabs."""
        sizes = self.sizes(self.rows)
        return str(sizes[0]) if self.is_equal else " / ".join(map(str, sizes))


def choose_cut(rows: int, n: int, strides: Sequence[int] = ()) -> Cut:
    """The cut of ``rows`` input rows into ``n`` slabs for a model of ``strides`` along the cut axis (the module's
    rule): equal where ``n`` divides ``rows``; else near-equal on the grid of the longest product of ``strides`` that
    leaves at least ``n`` grid rows; with more slabs than rows, a row each for the first ``rows`` and none for the
    others."""
    if n < 1 or rows < 1:
        raise ValueError(f"slabs: {n} slabs of an input of {rows} rows")
    if n > rows:
        return Cut(rows, (1,) * rows + (0,) * (n - rows))
    if rows % n == 0:
        return Cut.equal(rows, n)
    grid = 1
    for product in itertools.accumulate((int(s) for s in strides), operator.mul):
        if rows % product or rows // product < n:
            break
        grid = product
    q, r = divmod(rows // grid, n)
    return Cut(rows, (q + 1,) * r + (q,) * (n - r))


@dataclass(frozen=True)
class Slabs:
    """This process's slab: the ``index``-th of the ``n`` parts of the first spatial axis, over ``axis`` of ``mesh``,
    as ``cut`` cuts it (given as None: equal parts)."""

    mesh: Mesh
    axis: str = "model"
    cut: Optional[Cut] = None

    def __post_init__(self) -> None:
        if self.cut is None:  # equal parts; each tensor brings its rows (line_cut)
            object.__setattr__(self, "cut", Cut.equal(self.n, self.n))
        elif self.cut.n != self.n:
            raise ValueError(f"slabs: a cut into {self.cut.n} slabs on an axis of {self.n} processes")

    @property
    def n(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def index(self) -> int:
        return self.mesh.axis_index(self.axis)

    def whole_rows(self, rows: int) -> int:
        """The whole tensor's rows along the cut axis, where this slab holds ``rows`` of them.

        An empty slab (more slabs than rows) cannot tell them from its own
        rows: it takes the line's input rows, the only rows the route leaves
        on such a cut (``empty_route``: the whole model gathered)."""
        parts = self.cut.parts
        if parts[self.index] == 0:
            if rows:
                raise ValueError(f"slabs: the empty slab {self.index} of the cut {self.cut.describe()} holds {rows} rows")
            return self.cut.rows
        return rows * sum(parts) // parts[self.index]

    def offset(self, rows: int) -> int:
        """This slab's first row in the whole tensor, where it holds ``rows`` rows."""
        return self.cut.offsets(self.whole_rows(rows))[self.index]

    def line_cut(self, rows: int) -> Cut:
        """The line's cut of an input of which this slab holds ``rows`` rows."""
        cut = Cut(self.whole_rows(rows), self.cut.parts)
        if cut.shares(cut.rows)[self.index] != rows:
            raise ValueError(f"slabs: slab {self.index} of the cut {self.cut.describe()} does not hold {rows} rows")
        return cut

    def gather_slabs(self, x: torch.Tensor, dim: int = 1, count_once: bool = False) -> torch.Tensor:
        """:func:`~.collectives.gather_slabs` of this slab ``x`` over the line's cut."""
        return gather_slabs(x, self.mesh, self.axis, dim, count_once, self.cut.sizes(self.whole_rows(x.shape[dim])))

    def cut_slab(self, t: torch.Tensor, dim: int = 1, count_once: bool = False) -> torch.Tensor:
        """:func:`~.collectives.cut_slab` of the whole tensor ``t`` over the line's cut."""
        return cut_slab(t, self.mesh, self.axis, dim, count_once, self.cut.sizes(t.shape[dim]))


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


def empty_route(cut: Cut) -> Optional[Route]:
    """The route ℓ = 0 (the whole model gathered) of a cut with empty slabs, which every model takes; else None."""
    if not cut.empty:
        return None
    return Route(0, f"{cut.n} slabs of an input of {cut.rows} rows: {cut.empty} hold no row")


def require_slab_path(model: nn.Module) -> None:
    """Raise ``NotImplementedError`` naming what ``model`` lacks to run on slabs; return if it has a slab path."""
    missing = getattr(model, "slab_path_missing", None)
    reason = f"{type(model).__name__} has no slab path" if missing is None else missing()
    if reason is not None:
        raise NotImplementedError(f"the spatial step (spatial_axis, shard_spatial) is not ported for this model: {reason}")


def slab_cut(model: nn.Module, rows: int, n: int) -> Cut:
    """The cut of an input of ``rows`` rows into ``n`` slabs for ``model`` (:func:`choose_cut` with its
    ``slab_strides``; a model without them is cut on a grid of one row)."""
    strides = getattr(model, "slab_strides", None)
    return choose_cut(rows, n, () if strides is None else strides())


def slab_route(model: nn.Module, cut: Cut) -> Route:
    """The route ``model`` takes on ``cut`` (its ``slab_route``; a model without one runs every layer on its slab)."""
    rule = getattr(model, "slab_route", None)
    return Route() if rule is None else rule(cut)


@contextlib.contextmanager
def on_slabs(model: nn.Module, slabs: Slabs) -> Iterator[nn.Module]:
    """Within the block, ``model`` takes and returns this process's slab ``(B, C, rows, S2, S3)`` of its input, cut as
    ``slabs.cut`` cuts it (equal slabs without a cut).

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
    whole = [slabs.gather_slabs(x, dim, count_once=True) for x in xs]
    with off_slabs(*modules), _same_draws(modules, slabs, whole[0]):
        return fn(*whole)


def whole_on_slabs(t: torch.Tensor, slabs: Slabs) -> torch.Tensor:
    """A gathered part's whole output, alike on every process, returned in place of a slab where the cut does not keep
    its rows whole on every slab (a deep-supervision head below the grid): its cotangent scaled by ``1 / n``
    (:func:`~.collectives.count_once`) and the tensor marked (:func:`is_whole`), so that a loss on slabs takes it
    whole."""
    t = count_once(t, slabs.mesh, slabs.axis)
    t.whole_on_slabs = True
    return t


def is_whole(t: torch.Tensor) -> bool:
    """Whether ``t``, a model's output on slabs, is whole on every process (:func:`whole_on_slabs`), not a slab."""
    return getattr(t, "whole_on_slabs", False)


def _cut_back(slabs: Slabs, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """A gathered part's whole output ``t``: this slab of it where the cut keeps its rows whole on every slab
    (``count_once``), else all of it (:func:`whole_on_slabs`)."""
    if slabs.cut.keeps(t.shape[dim]):
        return slabs.cut_slab(t, dim, count_once=True)
    return whole_on_slabs(t, slabs)


def run_whole(model: nn.Module, x: torch.Tensor, slabs: Slabs, dim: int) -> Any:
    """The route ℓ = 0: ``model`` on the whole input, gathered along ``dim``, on every process; its output (a tensor or
    a list of them) cut back along the same ``dim``, or whole where the cut does not keep its rows (:func:`_cut_back`)."""
    out = run_gathered(model, [model], slabs, x, dim=dim)
    if isinstance(out, (list, tuple)):
        return [_cut_back(slabs, t, dim) for t in out]
    return _cut_back(slabs, out, dim)


def run_ladder(x: torch.Tensor, down: Sequence[Callable], up: dict, merge: dict, keep: Sequence[int] = (),
               level: Optional[int] = None, slabs: Optional[Slabs] = None, modules: Sequence[nn.Module] = (),
               heads: Optional[dict] = None, head_dim: int = 1) -> dict[int, torch.Tensor]:
    """The U-shaped pass, channels-last, on this process's slab down to ``level`` and gathered from it.

    ``down[l](t)``: the encoder's level ``l`` from level ``l - 1`` (``x`` is
    level -1); the last is the bottleneck.  ``up[l](d)``: level ``l + 1``'s
    decoder output up to level ``l``; ``merge[l](skip, u)``: the decoder output
    at level ``l`` from the encoder's and ``u``, for each level the decoder
    reaches (the keys of ``merge``).  Returns each level's output for the levels
    in ``keep`` and in ``heads`` and the finest the decoder reaches: the
    decoder's where it reaches the level, else the encoder's; where ``heads``
    has the level, ``heads[l]`` of that output instead (a head's output, whose
    cut axis is ``head_dim``).

    ``level`` (at least 1, with ``slabs``): levels ``level`` and deeper run in
    one gathered part (:func:`run_gathered` over ``modules``), from the
    encoder's level ``level - 1`` to ``up[level - 1]``'s output, their heads
    with them on the whole level, and the outputs cut back, or kept whole where
    the cut does not keep their rows (a level below the grid,
    :func:`whole_on_slabs`); the others run on the slab.  None: every level as
    it is.
    """
    heads = heads or {}
    n_levels = len(down)
    finest = min(merge, default=n_levels - 1)
    want = sorted(set(keep) | set(heads) | {finest})
    first = n_levels if level is None else level

    def head(lv: int, t: torch.Tensor) -> torch.Tensor:
        return heads[lv](t) if lv in heads else t

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
        return {lv: head(lv, outs[lv]) for lv in want}

    def tail(t: torch.Tensor) -> list:
        deep: dict = {}
        d = encode(t, level, n_levels, deep)
        whole = dict(deep)
        d = decode(d, max(level, finest), n_levels - 2, deep, whole)
        return [head(lv, whole[lv]) for lv in want if lv >= level] + ([up[level - 1](d)] if level - 1 >= finest else [])

    gathered = run_gathered(tail, modules, slabs, skips[level - 1])
    deep_levels = [lv for lv in want if lv >= level]
    outs.update({lv: _cut_back(slabs, t, head_dim if lv in heads else 1) for lv, t in zip(deep_levels, gathered)})
    if level - 1 >= finest:
        d = outs[level - 1] = merge[level - 1](skips[level - 1], slabs.cut_slab(gathered[-1], count_once=True))
        decode(d, finest, level - 2, skips, outs)
    return {lv: outs[lv] if lv >= level else head(lv, outs[lv]) for lv in want}
