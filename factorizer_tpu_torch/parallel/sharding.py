"""This process's part of a batch, the data-parallel model, and the parameters cut over the model axis.

PyTorch counterpart of ``factorizer_tpu/parallel/sharding.py``:
``input_sharding`` (a sharding annotation there, a cut here, ``shard_batch``),
the gradient all-reduce that XLA inserts for a batch-sharded step
(``DistributedDataParallel`` here), and the model-axis layout of the weights:
``param_leaf_rule`` / ``param_sharding_rules`` decide, leaf for leaf as JAX
decides, which parameters are cut over ``model``, and ``shard_parameters``
(JAX's ``shard_variables`` / ``place_global``) holds each such parameter as
this process's part of it between steps.

GSPMD runs a sharded weight where it lies and inserts the collectives that
its users need; here the model's forward takes whole weights, so the step
gathers them first (one flat all-gather over the axis), runs the forward and
the backward on them, turns their whole gradients into the parts' gradients
(one flat reduce-scatter where the processes of the axis hold different parts
of the gradient, as on slabs; a local cut where they hold the same whole
gradient) and frees them.  What is sharded is the state held between steps,
the parameters and AdamW's moments, not the activations.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from .collectives import _staged
from .mesh import Mesh

__all__ = ["shard_batch", "data_parallel", "param_leaf_rule", "param_sharding_rules", "shard_parameters",
           "ShardedParameters"]

def _cut(t: torch.Tensor, dim: int, mesh: Mesh, axis: Optional[str],
         sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    if axis is None or axis not in mesh.shape:
        return t
    n, rows = mesh.axis_size(axis), t.shape[dim]
    if sizes is None:
        if rows % n:
            raise ValueError(f"dim {dim} of shape {tuple(t.shape)} does not split into {n} equal shards over {axis!r}")
        sizes = (rows // n,) * n
    elif len(sizes) != n or sum(sizes) != rows:
        raise ValueError(f"dim {dim} of shape {tuple(t.shape)} does not split into the shards {list(sizes)} over {axis!r}")
    i = mesh.axis_index(axis)
    return t.narrow(dim, sum(sizes[:i]), sizes[i])


def shard_batch(batch, mesh: Mesh, data_axis: str = "data", spatial_axis: Optional[str] = None,
                sizes: Optional[Sequence[int]] = None):
    """This process's shard of a global batch of channels-first tensors ``(B, C, *S)``.

    ``batch`` is a tensor or a dict of tensors that every process holds in
    full.  The batch dim is cut over ``data_axis`` and, with ``spatial_axis``,
    the first spatial dim over that axis; an axis the mesh lacks cuts nothing.
    The batch's shards are equal or the call raises: the mean of the shards'
    losses is the batch's loss only then.  The spatial cut is equal too, or
    with ``sizes`` (each slab's rows in axis order, from the line's
    ``parallel.slabs.Cut``) slabs of those rows.
    """
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, data_axis, spatial_axis, sizes) for k, v in batch.items()}
    return _cut(_cut(batch, 0, mesh, data_axis), 2, mesh, spatial_axis, sizes).contiguous()


def data_parallel(model: nn.Module, mesh: Mesh, data_axis: str = "data") -> DistributedDataParallel:
    """``model`` with its gradients averaged over ``data_axis`` during the backward.

    The wrapper shares ``model``'s parameters (an optimiser built on either
    sees the same tensors) and copies those of the axis's first process to the
    others when it is built.  ``broadcast_buffers=False``: the NMF tables are
    buffers and come from the seed on every process alike.
    """
    device = next(model.parameters()).device
    ids = [device.index] if device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=ids, process_group=mesh.group(data_axis), broadcast_buffers=False)


def param_leaf_rule(mesh: Mesh, model_axis: Optional[str] = "model",
                    min_weight_size: int = 2**14) -> Callable[[Sequence[int]], Optional[str]]:
    """JAX's rule as a function of a leaf's shape: the axis its last dim is cut over, or None (whole).

    A leaf is cut over ``model_axis`` when the mesh has that axis at a size
    ``n`` above 1 and the leaf has at least 2 dims, at least
    ``min_weight_size`` elements and a last dim that ``n`` divides.  The shape
    is the JAX package's (``utils.weights.flax_leaf_shapes`` gives it for a
    port parameter): a conv's last JAX axis is its output channels, an
    attention's query kernel ``(in, heads, head_dim)`` ends in ``head_dim``.
    """
    n = mesh.shape.get(model_axis, 1) if model_axis is not None else 1

    def rule(shape: Sequence[int]) -> Optional[str]:
        size = 1
        for s in shape:
            size *= s
        if n > 1 and len(shape) >= 2 and size >= min_weight_size and shape[-1] % n == 0:
            return model_axis
        return None

    return rule


def param_sharding_rules(model: nn.Module, mesh: Mesh, model_axis: Optional[str] = "model",
                         min_weight_size: int = 2**14) -> dict[str, Optional[str]]:
    """Parameter name -> the axis :func:`param_leaf_rule` cuts it over (None: whole), judged on its JAX leaf's shape.

    The JAX rule also reaches the buffers; the port's buffers (the NMF tables,
    the Deconver's filter seeds) stay whole on every process, since no step
    changes them.
    """
    from ..utils.weights import flax_leaf_shapes

    rule = param_leaf_rule(mesh, model_axis, min_weight_size)
    return {name: rule(shape) for name, shape in flax_leaf_shapes(model).items()}


def _all_gather_flat(flat: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``(n * len(flat),)``: every process's ``flat`` of ``axis`` in axis order (staged through the host under gloo)."""
    group = mesh.group(axis)
    staged = _staged(flat, group)
    mine = flat.cpu() if staged else flat
    out = mine.new_empty(mesh.axis_size(axis) * mine.numel())
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, mine, group=group)
    return out.to(flat.device)


def _reduce_scatter_flat(flat: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """This process's ``1 / n`` of the sum of every process's ``flat`` of ``axis`` (staged through the host under gloo)."""
    group = mesh.group(axis)
    staged = _staged(flat, group)
    mine = flat.cpu() if staged else flat
    out = mine.new_empty(mine.numel() // mesh.axis_size(axis))
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(out, mine, group=group)
    return out.to(flat.device)


class ShardedParameters:
    """The parameters of ``model`` named in ``names``, each held as this process's ``1 / n`` of it over ``axis``.

    A leaf of ``N`` elements is cut into ``n`` equal runs of its flattened
    elements (JAX's ``shape[-1] % n == 0`` makes ``N % n == 0``); process ``i``
    of the axis holds run ``i`` as ``shards[j]``, an ``nn.Parameter`` that the
    optimiser updates, so AdamW's moments of it are ``1 / n`` of the leaf too.
    AdamW and its weight decay act element by element, so where the cut falls
    changes no number.  The shards are views of one flat buffer (``flat``),
    each run starting on a 16-byte boundary, which is the all-gather's input.

    Between steps the model's own parameters of those leaves hold no
    elements.  :meth:`gather` makes them whole (collective), as views of one
    buffer whose leaves each start on a 16-byte boundary, as the kernels take
    them; :meth:`scatter_gradients` turns their whole gradients into the
    shards' and frees them (:meth:`release`).
    """

    def __init__(self, model: nn.Module, mesh: Mesh, axis: str, names: Sequence[str]) -> None:
        params = dict(model.named_parameters())
        self.model, self.mesh, self.axis = model, mesh, axis
        self.n, self.index = mesh.axis_size(axis), mesh.axis_index(axis)
        self.names = list(names)
        self.params = [params[k] for k in self.names]
        self.shapes = [tuple(p.shape) for p in self.params]
        kinds = {(p.dtype, p.device) for p in self.params}
        if len(kinds) != 1:
            raise ValueError(f"shard_parameters: the sharded leaves must share one dtype and device, got {kinds}")
        (self.dtype, self.device), = kinds
        align = max(1, 16 // torch.empty((), dtype=self.dtype).element_size())
        self.counts = [p.numel() // self.n for p in self.params]
        self.offsets, self.whole_offsets = [], []
        length = whole = 0
        for m in self.counts:
            self.offsets.append(length)
            self.whole_offsets.append(whole)
            length += -(-m // align) * align
            whole += -(-m * self.n // align) * align
        self.length, self.whole_length = length, whole
        self.flat = torch.zeros(length, dtype=self.dtype, device=self.device)
        with torch.no_grad():
            for p, m, o in zip(self.params, self.counts, self.offsets):
                self.flat[o:o + m].copy_(p.detach().reshape(-1)[self.index * m:(self.index + 1) * m])
        self.shards = [nn.Parameter(self.flat[o:o + m]) for m, o in zip(self.counts, self.offsets)]
        self.release()

    def optimizer_parameters(self) -> list[nn.Parameter]:
        """The parameters an optimiser of this layout updates, in the model's order: a shard in place of a sharded
        leaf, so that an optimiser's state is indexed as in a one-process run."""
        shard = {id(p): s for p, s in zip(self.params, self.shards)}
        return [shard.get(id(p), p) for p in self.model.parameters()]

    def replicated(self) -> list[nn.Parameter]:
        """The model's parameters that stay whole on every process."""
        sharded = {id(p) for p in self.params}
        return [p for p in self.model.parameters() if id(p) not in sharded]

    def release(self) -> None:
        """Free the whole leaves and their gradients: the model's parameters of them hold no elements."""
        for p in self.params:
            p.data = torch.empty(0, dtype=self.dtype, device=self.device)
            p.grad = None

    def _unpack(self, gathered: torch.Tensor) -> list[torch.Tensor]:
        """The whole leaves from an all-gather of flat buffers, in one new buffer of this layout's whole offsets."""
        whole = gathered.new_empty(self.whole_length)
        rows = gathered.view(self.n, self.length)
        out = []
        for shape, m, o, w in zip(self.shapes, self.counts, self.offsets, self.whole_offsets):
            leaf = whole[w:w + m * self.n]
            leaf.view(self.n, m).copy_(rows[:, o:o + m])
            out.append(leaf.view(shape))
        return out

    def gather_flat(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """The whole leaves of a flat buffer of this layout (``flat`` or one of the optimiser's moments packed as it
        is), by one all-gather over the axis (collective)."""
        return self._unpack(_all_gather_flat(flat, self.mesh, self.axis))

    def pack(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """One flat buffer of this layout from one tensor per shard (an optimiser's moment of each)."""
        flat = torch.zeros(self.length, dtype=self.dtype, device=self.device)
        for t, m, o in zip(parts, self.counts, self.offsets):
            flat[o:o + m].copy_(t.reshape(-1))
        return flat

    def cut(self, key: str, whole: torch.Tensor) -> torch.Tensor:
        """This process's part of the whole leaf ``key`` (a parameter or a moment of it), as its shard holds it."""
        m = self.counts[self.names.index(key)]
        return whole.reshape(-1)[self.index * m:(self.index + 1) * m]

    def gather(self) -> None:
        """Make the sharded leaves whole in the model (collective over the axis)."""
        with torch.no_grad():
            for p, leaf in zip(self.params, self.gather_flat(self.flat)):
                p.data = leaf

    @contextlib.contextmanager
    def gathered(self) -> Iterator[None]:
        """The model with whole leaves within the block (collective on entry), freed after it."""
        self.gather()
        try:
            yield
        finally:
            self.release()

    def scatter_gradients(self, summed: bool) -> None:
        """The shards' gradients from the whole leaves' gradients, then :meth:`release`.

        ``summed``: each process of the axis holds a part of every gradient
        (slabs), and a shard's gradient is the sum over the axis of its run, by
        one reduce-scatter; else every process holds the same whole gradient
        and keeps its own run.  A leaf without a gradient counts as zero.
        """
        with torch.no_grad():
            if summed:
                rows = torch.zeros(self.n, self.length, dtype=self.dtype, device=self.device)
                for p, m, o in zip(self.params, self.counts, self.offsets):
                    if p.grad is not None:
                        rows[:, o:o + m].copy_(p.grad.reshape(self.n, m))
                grads = _reduce_scatter_flat(rows.view(-1), self.mesh, self.axis)
            else:
                grads = torch.zeros(self.length, dtype=self.dtype, device=self.device)
                for p, m, o in zip(self.params, self.counts, self.offsets):
                    if p.grad is not None:
                        grads[o:o + m].copy_(p.grad.reshape(self.n, m)[self.index])
        for s, m, o in zip(self.shards, self.counts, self.offsets):
            s.grad = grads[o:o + m]
        self.release()


def shard_parameters(model: nn.Module, mesh: Mesh, model_axis: Optional[str] = "model",
                     min_weight_size: int = 2**14) -> Optional[ShardedParameters]:
    """JAX's ``shard_variables(variables, param_sharding_rules(...))`` for a port model: the leaves that the rule cuts
    held as this process's part of them (:class:`ShardedParameters`), or None where it cuts none (an axis of one,
    or no leaf large enough).

    Collective over the whole group: the first process's parameters go to the
    others first, so that every process cuts the same leaves.
    """
    if model_axis is None or mesh.shape.get(model_axis, 1) == 1:
        return None
    names = [k for k, axis in param_sharding_rules(model, mesh, model_axis, min_weight_size).items() if axis]
    if not names:
        return None
    with torch.no_grad():
        for p in model.parameters():
            dist.broadcast(p.data, src=0)
    return ShardedParameters(model, mesh, model_axis, names)
