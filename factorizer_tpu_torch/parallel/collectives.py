"""Exchanges over one axis of the mesh that must also work where gloo carries CUDA tensors.

``ring_exchange`` is the JAX package's ``lax.ppermute`` over a ring (``_ring``
and its two users in ``factorizer_tpu/ops/pallas/windowed_sharded.py:42-63``)
as ``torch.distributed.batch_isend_irecv``; ``all_gather_cat`` joins the
shards of a tensor that the JAX package holds as one sharded array.  gloo
takes device memory for all-reduce and broadcast only, so under gloo both
stage a CUDA tensor through the host, explicitly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["ring_exchange", "all_gather_cat"]


def _staged(tensor: torch.Tensor, group) -> bool:
    """Whether ``tensor`` has to cross the host: a CUDA tensor under gloo."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def ring_exchange(tensor: torch.Tensor, mesh: Mesh, axis: str, forward: bool = True) -> torch.Tensor:
    """Send ``tensor`` one step along the ring of ``axis`` and return what arrives from the other side.

    ``forward`` sends to the next index (cyclically) and receives from the
    previous one; otherwise the reverse.  Every process of the axis calls it
    with tensors of one shape and dtype.  A ring of one is a local copy.
    Under NCCL a CUDA tensor travels as it is; gloo's point-to-point calls
    take no device memory, so there a CUDA tensor is staged through the host
    (the copies run on the current stream, which orders them against the
    kernels around them).  Both requests are waited for before the call
    returns, so the buffers outlive the transport.
    """
    n = mesh.axis_size(axis)
    if n == 1:
        return tensor.clone()
    ranks, i, step = mesh.axis_ranks[axis], mesh.axis_index(axis), 1 if forward else -1
    group = mesh.group(axis)
    staged = _staged(tensor, group)
    send = tensor.contiguous()
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ranks[(i + step) % n], group),
           dist.P2POp(dist.irecv, recv, ranks[(i - step) % n], group)]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return recv.to(tensor.device) if staged else recv


def all_gather_cat(tensor: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The shards of all processes of ``axis``, in axis order, joined along ``dim``; equal shapes on every process."""
    group = mesh.group(axis)
    staged = _staged(tensor, group)
    mine = tensor.contiguous()
    if staged:
        mine = mine.cpu()
    parts = [torch.empty_like(mine) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, mine, group=group)
    return torch.cat(parts, dim).to(tensor.device)
