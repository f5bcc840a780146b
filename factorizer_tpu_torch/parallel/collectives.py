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
  last slab pad with zeros, unlike K5's ring, or repeat their edge row for a
  linear resize, ``edge="replicate"``); the backward sends the halo's
  cotangent back and adds it to the rows it came from;
* :func:`all_reduce_sum`: partial sums (the loss's) made whole on every
  process; the backward passes the cotangent through, so each process
  differentiates its own part;
* :func:`slab_sum`: partial sums (a norm's statistics) made whole on every
  process, whose slab's own rows then consume them; the backward sums the
  cotangent over the processes too, since every slab's rows contribute to it;
* :func:`gather_slabs` / :func:`cut_slab`: a slab joined into the whole
  tensor on every process, and cut back out; each one's backward is the
  other, so between the two every process holds the same tensor and the same
  cotangent.  The slabs may hold unequal rows (``sizes``, each slab's rows
  in axis order, from ``parallel.slabs.Cut``): the gather pads each to the
  largest and trims it, the cut takes each slab's offset.  With ``count_once=True``
  the layers between the two hold parameters: every process computes their
  whole gradient, whatever its slab's rows, so the cotangent between is
  scaled by ``1 / n`` and the sum over the axis counts it once.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["ring_exchange", "all_gather_cat", "broadcast_from_first", "halo_exchange", "all_reduce_sum", "slab_sum",
           "gather_slabs", "cut_slab", "count_once"]


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


def all_gather_cat(tensor: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0,
                   sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The shards of all processes of ``axis``, in axis order, joined along ``dim``.

    Equal shapes on every process, or with ``sizes`` (each process's rows
    along ``dim``, in axis order) shapes that differ along ``dim`` alone:
    ``dist.all_gather`` takes one shape, so each shard travels padded to the
    largest and is trimmed after.
    """
    n = mesh.axis_size(axis)
    if n == 1:
        return tensor
    group = mesh.group(axis)
    staged = _staged(tensor, group)
    mine = tensor.contiguous()
    if staged:
        mine = mine.cpu()
    if sizes is not None:
        if len(sizes) != n or sizes[mesh.axis_index(axis)] != tensor.shape[dim]:
            raise ValueError(f"all_gather_cat: a shard of {tensor.shape[dim]} rows as shard "
                             f"{mesh.axis_index(axis)} of the sizes {list(sizes)}")
        if max(sizes) > mine.shape[dim]:
            pad = list(mine.shape)
            pad[dim] = max(sizes) - mine.shape[dim]
            mine = torch.cat([mine, mine.new_zeros(pad)], dim)
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine, group=group)
    if sizes is not None:
        parts = [p.narrow(dim, 0, rows) for p, rows in zip(parts, sizes)]
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
    def forward(ctx, x, mesh, axis, width, dim, replicate):
        ctx.mesh, ctx.axis, ctx.width, ctx.dim, ctx.replicate = mesh, axis, width, dim, replicate
        rows = x.shape[dim]
        top = _line_shift(x.narrow(dim, rows - width, width), mesh, axis, forward=True)
        bottom = _line_shift(x.narrow(dim, 0, width), mesh, axis, forward=False)
        if replicate:  # the volume's first and last rows stand in for what lies beyond them
            i, n = mesh.axis_index(axis), mesh.axis_size(axis)
            if i == 0:
                top = x.narrow(dim, 0, 1).expand_as(top)
            if i == n - 1:
                bottom = x.narrow(dim, rows - 1, 1).expand_as(bottom)
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, width, dim = ctx.mesh, ctx.axis, ctx.width, ctx.dim
        rows = g.shape[dim] - 2 * width
        dx = g.narrow(dim, width, rows).clone()
        # The top halo came from the previous slab's last rows, the bottom halo from the next slab's first rows.
        dx.narrow(dim, rows - width, width).add_(_line_shift(g.narrow(dim, 0, width), mesh, axis, forward=False))
        dx.narrow(dim, 0, width).add_(_line_shift(g.narrow(dim, width + rows, width), mesh, axis, forward=True))
        if ctx.replicate:  # at the volume's ends the halo was this slab's own edge row
            i, n = mesh.axis_index(axis), mesh.axis_size(axis)
            if i == 0:
                dx.narrow(dim, 0, 1).add_(g.narrow(dim, 0, width).sum(dim, keepdim=True))
            if i == n - 1:
                dx.narrow(dim, rows - 1, 1).add_(g.narrow(dim, width + rows, width).sum(dim, keepdim=True))
        return dx, None, None, None, None, None


def halo_exchange(x: torch.Tensor, mesh: Mesh, axis: str, width: int, dim: int = 1, edge: str = "zeros") -> torch.Tensor:
    """This slab with ``width`` rows of each neighbour's along ``dim``; beyond the volume's first and last slab,
    zeros (``edge="zeros"``) or that slab's edge row repeated (``edge="replicate"``).

    ``x`` is this process's slab of a tensor cut along ``dim`` over ``axis``;
    a convolution of valid padding along ``dim`` on the result equals the
    zero-padded convolution of the whole tensor, cut; with ``"replicate"``,
    a resize on the result equals the edge-clamped resize of the whole tensor.
    Collective over the axis, in the backward too.
    """
    if not 0 < width <= x.shape[dim]:
        raise ValueError(f"halo_exchange: a halo of {width} rows from a slab of {x.shape[dim]}")
    if edge not in ("zeros", "replicate"):
        raise ValueError(f"halo_exchange: edge must be 'zeros' or 'replicate', got {edge!r}")
    return _Halo.apply(x, mesh, axis, width, dim, edge == "replicate")


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


class _SlabSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        out = t.clone()
        dist.all_reduce(out, group=mesh.group(axis))
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.mesh.group(ctx.axis))
        return g, None, None


def slab_sum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over the processes of ``axis``, on each; the backward sums the cotangent over them too.

    For a statistic ``m = sum_r t_r`` that each process's own slab then
    consumes (a norm's mean or variance), the loss reaches ``m`` through every
    slab, so ``d loss / d t_r`` is the sum over the processes of what each
    one's slab sends back.  :func:`all_reduce_sum`, which hands the cotangent
    through, would give each process its own slab's part alone.  Collective
    over the axis, forward and backward.
    """
    if mesh.axis_size(axis) == 1:
        return t
    return _SlabSum.apply(t, mesh, axis)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def count_once(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x``, a whole tensor that every process of ``axis`` computes alike from parameters, kept whole (not cut): the
    backward scales its cotangent by ``1 / n``, as :func:`cut_slab`'s ``count_once`` does, so that the sum over the
    axis counts the gradient of what computed it once."""
    n = mesh.axis_size(axis)
    return x if n == 1 else _ScaleGrad.apply(x, 1.0 / n)


def _narrow(t: torch.Tensor, mesh: Mesh, axis: str, dim: int, sizes: tuple) -> torch.Tensor:
    i = mesh.axis_index(axis)
    return t.narrow(dim, sum(sizes[:i]), sizes[i]).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, sizes):
        ctx.mesh, ctx.axis, ctx.dim, ctx.sizes = mesh, axis, dim, sizes
        return all_gather_cat(x, mesh, axis, dim, sizes=sizes)

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, ctx.mesh, ctx.axis, ctx.dim, ctx.sizes), None, None, None, None


class _Cut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, sizes):
        ctx.mesh, ctx.axis, ctx.dim, ctx.sizes = mesh, axis, dim, sizes
        return _narrow(x, mesh, axis, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim, sizes=ctx.sizes), None, None, None, None


def gather_slabs(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 1, count_once: bool = False,
                 sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The whole tensor from the slabs of ``axis``, on every process; the backward cuts this slab's rows back out.

    ``sizes``: each slab's rows along ``dim``, in axis order (None: every
    slab holds as many as ``x``).  The cotangent that reaches it must be the
    whole one, alike on every process: what :func:`cut_slab`'s backward hands
    on.  ``count_once``: see :func:`cut_slab`; the backward multiplies the
    cotangent by ``n`` again.
    """
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    whole = _Gather.apply(x, mesh, axis, dim, (x.shape[dim],) * n if sizes is None else tuple(sizes))
    return _ScaleGrad.apply(whole, float(n)) if count_once else whole


def cut_slab(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 1, count_once: bool = False,
             sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """This process's slab of a tensor that every process of ``axis`` holds whole; the backward gathers the cotangent.

    ``sizes``: each slab's rows along ``dim``, in axis order, summing to
    ``x``'s (None: equal slabs); rows that do not cut so raise.
    ``count_once=True`` (with the matching :func:`gather_slabs`): the layers
    between the two have parameters, whose gradient every process computes
    whole and the spatial step then sums over the axis.  The backward scales
    the cotangent that enters them by ``1 / n``, whatever the slabs' rows, so
    that the sum counts their gradient once: exactly for a power of two, to
    the last bits otherwise.
    """
    n, rows = mesh.axis_size(axis), x.shape[dim]
    if n == 1:
        return x
    if sizes is None:
        if rows % n:
            raise ValueError(f"cut_slab: {rows} rows do not cut into {n} equal slabs")
        sizes = (rows // n,) * n
    elif len(sizes) != n or sum(sizes) != rows:
        raise ValueError(f"cut_slab: {rows} rows do not cut into the slabs {list(sizes)}")
    return _Cut.apply(_ScaleGrad.apply(x, 1.0 / n) if count_once else x, mesh, axis, dim, tuple(sizes))
