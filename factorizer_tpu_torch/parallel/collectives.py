"""Exchanges over one axis of the mesh that must also work where gloo carries CUDA tensors.

``ring_exchange`` is the JAX package's ``lax.ppermute`` over a ring (``_ring``
and its two users in ``factorizer_tpu/ops/pallas/windowed_sharded.py:42-63``)
as ``torch.distributed.batch_isend_irecv``; ``all_gather_cat`` joins the
shards of a tensor that the JAX package holds as one sharded array.  gloo
takes device memory for all-reduce and broadcast only, so under gloo the
point-to-point calls and the all-gather stage a CUDA tensor through the host,
explicitly.

The whole-model spatial step (``parallel.slabs``) needs what GSPMD inserts
for a volume sharded along its first spatial axis, each as an autograd
function with its own backward:

* :func:`halo_exchange`: a convolution's halo, *not* cyclic (the first and
  last slab pad with zeros, unlike K5's ring); the backward sends the halo's
  cotangent back and adds it to the rows it came from;
* :func:`all_reduce_sum`: partial sums (the loss's) made whole on every
  process; the backward passes the cotangent through, so each process
  differentiates its own part;
* :func:`gather_slabs` / :func:`cut_slab`: a slab joined into the whole
  tensor on every process, and cut back out; each one's backward is the
  other, so between the two every process holds the same tensor and the same
  cotangent.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["ring_exchange", "all_gather_cat", "broadcast_from_first", "halo_exchange", "all_reduce_sum", "gather_slabs",
           "cut_slab"]


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
    if mesh.axis_size(axis) == 1:
        return tensor
    group = mesh.group(axis)
    staged = _staged(tensor, group)
    mine = tensor.contiguous()
    if staged:
        mine = mine.cpu()
    parts = [torch.empty_like(mine) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, mine, group=group)
    return torch.cat(parts, dim).to(tensor.device)


def broadcast_from_first(tensor: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``tensor`` of the first process of ``axis``, in place on every process of it (equal shapes and dtypes)."""
    if mesh.axis_size(axis) > 1:
        dist.broadcast(tensor, src=mesh.axis_ranks[axis][0], group=mesh.group(axis))
    return tensor


def _line_shift(tensor: torch.Tensor, mesh: Mesh, axis: str, forward: bool) -> torch.Tensor:
    """What the neighbour before (``forward``) or after this process on ``axis`` sends, zeros at the line's end.

    Not cyclic: the last process sends nothing forward, the first nothing
    backward.  Collective over the axis; staged through the host under gloo.
    """
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    step = 1 if forward else -1
    ranks, group = mesh.axis_ranks[axis], mesh.group(axis)
    send = tensor.contiguous()
    staged = n > 1 and _staged(send, group)
    if staged:
        send = send.cpu()
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= i + step < n:
        ops.append(dist.P2POp(dist.isend, send, ranks[i + step], group))
    if 0 <= i - step < n:
        ops.append(dist.P2POp(dist.irecv, recv, ranks[i - step], group))
    if ops:
        for request in dist.batch_isend_irecv(ops):
            request.wait()
    return recv.to(tensor.device) if staged else recv


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, width, dim):
        ctx.mesh, ctx.axis, ctx.width, ctx.dim = mesh, axis, width, dim
        rows = x.shape[dim]
        top = _line_shift(x.narrow(dim, rows - width, width), mesh, axis, forward=True)
        bottom = _line_shift(x.narrow(dim, 0, width), mesh, axis, forward=False)
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, width, dim = ctx.mesh, ctx.axis, ctx.width, ctx.dim
        rows = g.shape[dim] - 2 * width
        dx = g.narrow(dim, width, rows).clone()
        # The top halo came from the previous slab's last rows, the bottom halo from the next slab's first rows.
        dx.narrow(dim, rows - width, width).add_(_line_shift(g.narrow(dim, 0, width), mesh, axis, forward=False))
        dx.narrow(dim, 0, width).add_(_line_shift(g.narrow(dim, width + rows, width), mesh, axis, forward=True))
        return dx, None, None, None, None


def halo_exchange(x: torch.Tensor, mesh: Mesh, axis: str, width: int, dim: int = 1) -> torch.Tensor:
    """This slab with ``width`` rows of each neighbour's along ``dim``: zeros beyond the volume's first and last slab.

    ``x`` is this process's slab of a tensor cut along ``dim`` over ``axis``;
    a convolution of valid padding along ``dim`` on the result equals the
    zero-padded convolution of the whole tensor, cut.  Collective over the
    axis, in the backward too.
    """
    if not 0 < width <= x.shape[dim]:
        raise ValueError(f"halo_exchange: a halo of {width} rows from a slab of {x.shape[dim]}")
    return _Halo.apply(x, mesh, axis, width, dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        out = t.clone()
        dist.all_reduce(out, group=mesh.group(axis))
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over the processes of ``axis``, on each; the backward hands the cotangent through unchanged.

    For a quantity ``f(sum_r t_r)`` that every process computes alike, each
    process's backward then gives the gradient with respect to its own
    ``t_r``.  Collective over the axis in the forward only.
    """
    if mesh.axis_size(axis) == 1:
        return t
    return _AllReduceSum.apply(t, mesh, axis)


def _cut(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    return t.chunk(mesh.axis_size(axis), dim)[mesh.axis_index(axis)].contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather_cat(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _cut(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _Cut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _cut(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None, None


def gather_slabs(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 1) -> torch.Tensor:
    """The whole tensor from the slabs of ``axis``, on every process; the backward cuts this slab's rows back out.

    The cotangent that reaches it must be the whole one, alike on every
    process: what :func:`cut_slab`'s backward hands on.
    """
    if mesh.axis_size(axis) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim)


def cut_slab(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 1) -> torch.Tensor:
    """This process's slab of a tensor that every process of ``axis`` holds whole; the backward gathers the cotangent."""
    if mesh.axis_size(axis) == 1:
        return x
    return _Cut.apply(x, mesh, axis, dim)
