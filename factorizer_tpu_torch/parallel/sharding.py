"""This process's part of a batch, and the data-parallel model.

PyTorch counterpart of ``input_sharding`` in
``factorizer_tpu/parallel/sharding.py`` (a sharding annotation there, a cut
here) and of the gradient all-reduce that XLA inserts for a batch-sharded
step (``DistributedDataParallel`` here).  ``param_sharding_rules`` (tensor
parallelism through GSPMD) has no counterpart.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from .mesh import Mesh

__all__ = ["shard_batch", "data_parallel"]


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
