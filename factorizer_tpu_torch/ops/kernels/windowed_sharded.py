"""K5: shifted-window rank-1 NMF mixing of a volume cut into slabs along its first spatial axis
(``csrc/windowed_nmf_slab.cu``, ``csrc/windowed_nmf_slab_bwd.cu``).

Counterpart of ``windowed_nmf_multi_spatial`` in
``factorizer_tpu/ops/pallas/windowed_sharded.py``: K1's function
(:mod:`.windowed_nmf`) on ``(B, S1, S2, S3, C)`` where S1 is cut into ``n``
slabs over a ring of processes, each of its own ``L`` rows, a multiple of the
patch (equal slabs, ``L = S1 / n``, or unequal ones, ``parallel.slabs.Cut``).
Per shift ``(s1, s2, s3)`` a slab's first window row covers the rows
``[-s1, p - s1)``, the left neighbour's below 0.  With ``H`` the largest
``s1`` of the shifts, a mixer's forward is

1. one exchange forward along the ring: the left neighbour's last ``H`` rows
   (the *halo*, in the slab's dtype), which serve every shift;
2. pass A (:func:`windowed_nmf_slab_factors`, one launch): K1's factors pass
   on the slab, reading rows below 0 from the halo; it also writes the
   *routed factors*: for each shift that moves rows and each matrix of the
   slab's first window row, ``u`` and ``v``'s entries on those ``s1`` rows (f32);
3. one exchange backward along the ring carries the routed factors;
4. pass B (:func:`windowed_nmf_slab_reconstruct`, one launch): K1's
   reconstruct pass, each element written once; a row whose window lies in
   the right neighbour's first window row takes the factors that arrived.

The backward has one exchange forward for the halos of ``x`` and of the
cotangent ``g``, one launch per shift (K1 bwd's block, its values for the
slab's last ``H`` rows into a per-shift edge slot and those for the left
neighbour into a per-shift send slot, f32), one exchange backward for the send
slots, and one ordered tail (:func:`windowed_nmf_slab_tail`) that sums the last
``H`` rows' passes in order.  A list of shifts none of which moves rows
exchanges nothing.  ``u0`` and ``v0`` get no gradient.  :func:`exchange_sizes`
counts what a slab hands to the exchanges (``FactMixer.gathers`` weighs it
against gathering the slabs).

The result equals K1 on the gathered volume bit for bit: on the card the same
kernels sum in K1's order (the forward as K1's reconstruct pass, the backward
as K1 bwd's passes, scaled by ``1 / n`` at the end); on the CPU the plain
passes equal :func:`windowed_nmf_plain` and its autograd (the backward's
cotangent divided by ``n`` first and its passes summed last to first, as
autograd sums that function's branches).

:func:`windowed_nmf_multi_spatial` is the entry point for one slab per
process (``torch.distributed`` carries the exchanges);
:func:`windowed_nmf_multi_spatial_local` holds a whole ring's slabs in one
process and differs from it in the exchange alone.  Both are one
``torch.autograd.Function`` whose backward launches the backward kernels.
CPU tensors take the plain passes; :func:`windowed_nmf_multi_spatial_plain`
is the plain PyTorch version of the whole ring, which autograd differentiates.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional, Sequence

import torch

from ...parallel.collectives import ring_exchange
from . import build
from .windowed_nmf import (
    EPS,
    _check,
    _f32_table,
    _norm_shift,
    _shift_table,
    _sum_scratch,
    factor_shapes,
    windowed_nmf_backward_plain,
    windowed_nmf_factors_plain,
    windowed_nmf_plain,
    windowed_nmf_reconstruct_plain,
)

__all__ = [
    "windowed_nmf_multi_spatial", "windowed_nmf_multi_spatial_local", "windowed_nmf_multi_spatial_plain",
    "windowed_nmf_slab_factors", "windowed_nmf_slab_factors_plain", "windowed_nmf_slab_reconstruct",
    "windowed_nmf_slab_reconstruct_plain", "windowed_nmf_slab_backward_pass", "windowed_nmf_slab_backward_pass_plain",
    "windowed_nmf_slab_tail", "SlabSum", "exchange_sizes", "exchange_bytes",
]

# (tensors handed over, forward along the ring or backward) -> what arrives, slab for slab.
Exchange = Callable[[list, bool], list]
# Most shifts the ordered tail takes (``kMaxTailShifts`` in csrc/windowed_nmf_slab_bwd.cu).
MAX_TAIL_SHIFTS = 64


def _firsts(shifts, patch: int) -> list[int]:
    """Each shift's ``s1``: how many rows it moves between slabs."""
    return [_norm_shift(shift, patch)[0] for shift in shifts]


def exchange_sizes(shape: Sequence[int], head_dim: int, patch: int, shifts: Sequence) -> tuple[int, int, int]:
    """What a slab of ``shape`` hands to K5's exchanges, in elements: ``(halo, factors, rows)``.

    ``halo``: its last ``H`` rows, ``H`` the largest ``s1`` (the forward sends
    one halo, of ``x``, the backward two, of ``x`` and of the cotangent, in the
    slab's dtype); ``factors``: the forward's routed factors, for each shift
    that moves rows and each matrix of the first window row ``d + s1 p^2``;
    ``rows``: the backward's routed rows of ``dx``, ``s1`` rows a shift.  Both
    are f32 (f64 for an f64 slab).  All 0 where no shift moves rows.
    """
    batch, _, s2, s3, c = shape
    firsts = _firsts(shifts, patch)
    row = batch * s2 * s3 * c
    row_mats = batch * (s2 // patch) * (s3 // patch) * (c // head_dim)
    return max(firsts) * row, row_mats * sum(head_dim + s1 * patch**2 for s1 in firsts if s1), sum(firsts) * row


def exchange_bytes(shape: Sequence[int], itemsize: int, head_dim: int, patch: int, shifts: Sequence) -> int:
    """Bytes a slab of ``shape`` and ``itemsize`` hands to K5's exchanges in a forward and its backward."""
    halo, factors, rows = exchange_sizes(shape, head_dim, patch, shifts)
    return 3 * halo * itemsize + max(itemsize, 4) * (factors + rows)


def _route_views(route: torch.Tensor, shape, head_dim: int, patch: int, shifts) -> list:
    """Each shift's routed factors in ``route`` as a ``(B, G2 G3, C / d, d + s1 p^2)`` view: ``u``, then ``v`` on the
    rows ``a1 < s1``; None for a shift that moves no rows."""
    batch, _, s2, s3, c = shape
    lead = (batch, (s2 // patch) * (s3 // patch), c // head_dim)
    views, at = [], 0
    for s1 in _firsts(shifts, patch):
        size = math.prod(lead) * (head_dim + s1 * patch**2) if s1 else 0
        views.append(route[at:at + size].view(*lead, -1) if s1 else None)
        at += size
    return views


def _row_views(rows: torch.Tensor, shape, s1s: Sequence[int]) -> list:
    """Each shift's routed rows in ``rows`` as a ``(B, s1, S2, S3, C)`` view; None for a shift that moves none."""
    batch, _, *rest = shape
    views, at = [], 0
    for s1 in s1s:
        size = batch * s1 * math.prod(rest)
        views.append(rows[at:at + size].view(batch, s1, *rest) if s1 else None)
        at += size
    return views


def _padded(x: torch.Tensor, halo: Optional[torch.Tensor], s1: int) -> torch.Tensor:
    """The slab rolled by ``+s1`` along dim 1, in at least f32: the halo's last ``s1`` rows in front of the rows
    ``[0, L - s1)``."""
    wide = torch.promote_types(x.dtype, torch.float32)
    if not s1:
        return x.to(wide)
    return torch.cat([halo[:, halo.shape[1] - s1:].to(wide), x[:, : x.shape[1] - s1].to(wide)], 1)


def _check_slab(x, others, halos, u0, v0, head_dim: int, patch: int, rows: int, solver: str) -> None:
    """Raise on what the slab kernels do not take; ``rows`` is the halos' height, the largest ``s1``."""
    if x.ndim == 5 and x.shape[1] % patch:
        raise ValueError(f"a slab of {x.shape[1]} rows is no multiple of the patch {patch}: cut S1 so that every "
                         "slab holds whole windows")
    _check(x, u0, v0, head_dim, patch, solver)
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError("g must be a contiguous tensor of x's shape, dtype and device")
    want = (x.shape[0], rows, *x.shape[2:])
    for h in halos if rows else ():
        if h is None or tuple(h.shape) != want or h.dtype != x.dtype or h.device != x.device or not h.is_contiguous():
            raise ValueError(f"a shift of {rows} rows needs a contiguous halo of shape {want}, dtype {x.dtype}, "
                             f"on {x.device}")
    for name, t in (("a slab", x), *(("a slab", t) for t in others), *(("a halo", h) for h in (halos if rows else ()))):
        build.check_aligned(name, t)


def _check_f32(name: str, t: Optional[torch.Tensor], numel: int, device) -> None:
    if numel and (t is None or t.numel() != numel or t.dtype != torch.float32 or t.device != device
                  or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 tensor of {numel} elements on {device}")


def _launch(entry: str, count: str, *args) -> None:
    """One launch of a K5 entry point, a tensor argument as its data pointer; counted on ``count``."""
    status = getattr(build.library(), entry)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args))
    build.check(status, entry)
    setattr(windowed_nmf_multi_spatial, count, getattr(windowed_nmf_multi_spatial, count) + 1)


# --- the forward ---------------------------------------------------------------------------------------------------


def windowed_nmf_slab_factors_plain(x, halo, u0, v0, head_dim: int, patch: int, shifts: Sequence, solver: str = "hals",
                                    num_iters: int = 5, eps: float = EPS):
    """Pass A on one slab in plain PyTorch: per shift, K1's plain factors pass on the slab rolled by ``s1`` with
    the halo in front (dims 2 and 3 roll in place); ``(U, V, route)`` as :func:`windowed_nmf_slab_factors` gives
    them."""
    wide = torch.promote_types(x.dtype, torch.float32)
    u_shape, v_shape = factor_shapes(x.shape, head_dim, patch, len(shifts))
    U, V = x.new_empty(u_shape, dtype=wide), x.new_empty(v_shape, dtype=wide)
    route = x.new_empty(exchange_sizes(x.shape, head_dim, patch, shifts)[1], dtype=wide)
    first_row = u_shape[2] // (x.shape[1] // patch)  # the windows of one window row
    for k, (shift, rec) in enumerate(zip(shifts, _route_views(route, x.shape, head_dim, patch, shifts))):
        s1, s2, s3 = _norm_shift(shift, patch)
        Uk, Vk = windowed_nmf_factors_plain(_padded(x, halo, s1), u0, v0, head_dim, patch, ((0, s2, s3),), solver,
                                            num_iters, eps)
        U[k], V[k] = Uk[0], Vk[0]
        if rec is not None:
            rec[..., :head_dim] = Uk[0, :, :first_row]
            rec[..., head_dim:] = Vk[0, :, :first_row, :, : s1 * patch**2]
    return U, V, route


def windowed_nmf_slab_factors(x, halo, u0, v0, head_dim: int, patch: int, shifts: Sequence, solver: str = "hals",
                              num_iters: int = 5, eps: float = EPS):
    """Pass A on one slab: ``(U, V, route)`` in f32, one kernel launch on the card, plain on the CPU.

    ``x (B, L, S2, S3, C)`` is the slab, ``halo (B, H, S2, S3, C)`` the left
    neighbour's last ``H`` rows, ``H`` the largest ``s1`` of ``shifts`` (None
    when it is 0).  ``U`` and ``V`` are K1's factors of the slab
    (:func:`factor_shapes`); ``route`` (flat, :func:`exchange_sizes`' second
    count) holds, shift by shift, the factors of the slab's first window row
    that the left neighbour needs.
    """
    if not build.launches_kernel(x):
        return windowed_nmf_slab_factors_plain(x, halo, u0, v0, head_dim, patch, shifts, solver, num_iters, eps)
    rows = max(_firsts(shifts, patch))
    _check_slab(x, (), (halo,), u0, v0, head_dim, patch, rows, solver)
    u_shape, v_shape = factor_shapes(x.shape, head_dim, patch, len(shifts))
    U = torch.empty(u_shape, dtype=torch.float32, device=x.device)
    V = torch.empty(v_shape, dtype=torch.float32, device=x.device)
    route = torch.empty(exchange_sizes(x.shape, head_dim, patch, shifts)[1], dtype=torch.float32, device=x.device)
    _launch("ftt_windowed_nmf_slab_factors", "launches", x, halo if rows else None, U, V, route if rows else None,
            _f32_table(u0), _f32_table(v0), build.dtype_code(x.dtype), *x.shape, head_dim, patch, rows, len(shifts),
            _shift_table(shifts, patch), int(solver == "mu"), num_iters, eps, build.stream_of(x))
    return U, V, route


def windowed_nmf_slab_reconstruct_plain(U, V, recv, shape: Sequence[int], dtype: torch.dtype, head_dim: int,
                                        patch: int, shifts: Sequence) -> torch.Tensor:
    """Pass B on one slab in plain PyTorch: K1's plain reconstruct pass on the slab and one window row more, the
    right neighbour's first, whose factors arrived in ``recv``; the rows past the slab are dropped."""
    n, batch, windows, heads, d = U.shape
    g1 = shape[1] // patch
    per_row = windows // g1
    Ue = U.new_zeros(n, batch, g1 + 1, per_row, heads, d)
    Ve = V.new_zeros(n, batch, g1 + 1, per_row, heads, patch**3)
    Ue[:, :, :g1], Ve[:, :, :g1] = U.view(n, batch, g1, per_row, heads, d), V.view(n, batch, g1, per_row, heads, -1)
    for k, (shift, rec) in enumerate(zip(shifts, _route_views(recv, shape, head_dim, patch, shifts))):
        if rec is not None:
            Ue[k, :, g1] = rec[..., :head_dim]
            Ve[k, :, g1, :, :, : rec.shape[-1] - head_dim] = rec[..., head_dim:]
    grown = (batch, shape[1] + patch, *shape[2:])
    y = windowed_nmf_reconstruct_plain(Ue.view(n, batch, -1, heads, d), Ve.view(n, batch, -1, heads, patch**3),
                                       grown, dtype, head_dim, patch, shifts)
    return y[:, : shape[1]].contiguous()


def windowed_nmf_slab_reconstruct(U, V, recv, shape: Sequence[int], dtype: torch.dtype, head_dim: int, patch: int,
                                  shifts: Sequence) -> torch.Tensor:
    """Pass B on one slab: the mean over shifts of the factors' product, a ``shape`` slab of ``dtype``; one kernel
    launch on the card, plain on the CPU.  ``recv`` holds the routed factors that arrived from the right neighbour
    (laid out as :func:`windowed_nmf_slab_factors` writes them; None when no shift moves rows)."""
    if not build.launches_kernel(U):
        return windowed_nmf_slab_reconstruct_plain(U, V, recv, shape, dtype, head_dim, patch, shifts)
    u_shape, v_shape = factor_shapes(shape, head_dim, patch, len(shifts))
    for name, t, want in (("U", U, u_shape), ("V", V, v_shape)):
        if tuple(t.shape) != want or t.dtype != torch.float32 or not t.is_contiguous() or t.device != U.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor of shape {want} on {U.device}")
    _check_f32("the routed factors", recv, exchange_sizes(shape, head_dim, patch, shifts)[1], U.device)
    out = torch.empty(tuple(shape), dtype=dtype, device=U.device)
    for name, t in (("U", U), ("V", V), ("the routed factors", recv), ("out", out)):
        if t is not None:
            build.check_aligned(name, t)
    _launch("ftt_windowed_nmf_slab_reconstruct", "launches", U, V, recv, _sum_scratch(shape, len(shifts), U.device), out,
            build.dtype_code(dtype), *shape, head_dim, patch, len(shifts), _shift_table(shifts, patch),
            build.stream_of(U))
    return out


# --- the backward --------------------------------------------------------------------------------------------------


class SlabSum:
    """One slab's ``dx`` over the shift passes of the backward.

    The rows ``[0, L - H)`` take each pass as K1 bwd's ``store_pass`` does:
    the first starts the f32 scratch ``acc``, the middle ones add to it and
    the last scales by ``scale`` and casts into ``out`` (with a single pass
    there is no scratch).  The last ``H`` rows (``H`` the largest ``s1``) are
    the ordered tail's: pass ``k`` keeps its values for the rows
    ``[L - H, L - s1)`` in its edge slot ``own[k]`` and its values for the left
    neighbour's last ``s1`` rows in its slot of ``send`` (all f32).  ``order``
    is the order of the passes, ``i`` counts those done.  On the card the
    passes run first to last and ``scale`` is ``1 / n``; on the CPU last to
    first with ``scale`` 1, the cotangent being divided by ``n`` first
    (:func:`windowed_nmf_slab_backward_pass_plain`).
    """

    def __init__(self, like: torch.Tensor, shifts: Sequence[tuple], plain: bool) -> None:
        n = len(shifts)
        self.shifts, self.s1 = list(shifts), [s[0] for s in shifts]
        self.H, self.i = max(self.s1), 0
        if self.H and not plain and n > MAX_TAIL_SHIFTS:
            raise ValueError(f"K5's backward takes at most {MAX_TAIL_SHIFTS} shifts, got {n}")
        self.order = list(reversed(range(n))) if plain else list(range(n))
        self.scale = 1.0 if plain else 1.0 / n
        wide = torch.promote_types(like.dtype, torch.float32)
        self.out = torch.empty_like(like)
        self.acc = torch.empty(like.shape, dtype=wide, device=like.device) if n > 1 else None
        batch, _, *rest = like.shape
        self.own = torch.empty((n, batch, self.H, *rest), dtype=wide, device=like.device) if self.H else None
        self.send = like.new_empty(batch * sum(self.s1) * math.prod(rest), dtype=wide) if self.H else None

    @property
    def first(self) -> bool:
        return self.i == 0

    @property
    def last(self) -> bool:
        return self.i == len(self.shifts) - 1

    def slots(self, k: int) -> tuple:
        """Pass ``k``'s edge slot and send slot (None where it has none)."""
        if not self.H:
            return None, None
        return self.own[k], _row_views(self.send, self.out.shape, self.s1)[k]

    def put(self, y: torch.Tensor) -> None:
        """The plain version of ``store_pass`` on the rows ``[0, L - H)``."""
        body = slice(0, self.out.shape[1] - self.H)
        if self.first and self.last:
            self.out[:, body] = (y * self.scale).to(self.out.dtype)
        elif self.first:
            self.acc[:, body] = y
        elif not self.last:
            self.acc[:, body] += y
        else:
            self.out[:, body] = ((self.acc[:, body] + y) * self.scale).to(self.out.dtype)


def windowed_nmf_slab_backward_pass_plain(x, g, halos, u0, v0, head_dim: int, patch: int, shift: tuple,
                                          n_shifts: int = 1, solver: str = "hals", num_iters: int = 5,
                                          eps: float = EPS, num_grad_steps: Optional[int] = None):
    """One shift pass of the backward on one slab in plain PyTorch: ``(dx, send)``, both in at least f32.

    ``halos`` are ``x``'s and ``g``'s halos (None when no shift moves rows).
    Autograd of K1's plain function on the slab rolled by ``s1`` with the
    halos in front, for the cotangent ``g / n_shifts`` (what autograd hands
    each pass of :func:`windowed_nmf_plain`): ``dx`` on the rows ``[0, L - s1)``,
    ``send`` on the left neighbour's last ``s1`` rows (None when ``s1 = 0``).
    """
    s1, s2, s3 = shift
    x_halo, g_halo = (None, None) if halos is None else halos
    dxs = windowed_nmf_backward_plain(_padded(x, x_halo, s1), _padded(g, g_halo, s1) / n_shifts, u0, v0, head_dim,
                                      patch, ((0, s2, s3),), solver, num_iters, eps, num_grad_steps)
    return (dxs[:, s1:], dxs[:, :s1]) if s1 else (dxs, None)


def windowed_nmf_slab_backward_pass(x, g, halos, total: SlabSum, k: int, u0, v0, head_dim: int, patch: int,
                                    solver: str = "hals", num_iters: int = 5, eps: float = EPS, grad_steps: int = 5):
    """Pass ``k`` of ``dx`` on one slab: the backward slab kernel on the card, the plain pass on the CPU.

    ``x`` and the cotangent ``g`` are the slab's, ``halos`` the left
    neighbour's last ``H`` rows of each (None when ``H = 0``), ``total`` the
    slab's :class:`SlabSum` and ``k`` the pass's index in its shifts;
    ``grad_steps`` in ``[1, num_iters]`` is the number of trailing iterations
    differentiated.
    """
    shift, H = total.shifts[k], total.H
    own, send = total.slots(k)
    if not build.launches_kernel(x):
        dx, sent = windowed_nmf_slab_backward_pass_plain(x, g, halos, u0, v0, head_dim, patch, shift,
                                                         len(total.shifts), solver, num_iters, eps, grad_steps)
        total.put(dx[:, : x.shape[1] - H])
        if H:
            own[:, : H - shift[0]] = dx[:, x.shape[1] - H:]
        if send is not None:
            send.copy_(sent)
    else:
        x_halo, g_halo = (None, None) if halos is None else halos
        _check_slab(x, (g,), (x_halo, g_halo), u0, v0, head_dim, patch, H, solver)
        _launch("ftt_windowed_nmf_slab_shift_bwd", "backward_launches", x, g, x_halo, g_halo, total.acc, total.out,
                send, own, _f32_table(u0), _f32_table(v0), build.dtype_code(x.dtype), *x.shape, head_dim, patch, H,
                *shift, int(solver == "mu"), num_iters, grad_steps, eps, int(total.first), int(total.last),
                total.scale, build.stream_of(x))
    total.i += 1


def windowed_nmf_slab_tail(total: SlabSum, recv: Optional[torch.Tensor]) -> None:
    """Complete the slab's last ``H`` rows once every pass has run: each element sums its passes in ``total``'s
    order, each from the pass's edge slot or from ``recv``, the routed rows that arrived from the right neighbour
    (laid out as ``total.send``).  One kernel launch on the card, plain on the CPU; nothing where ``H = 0``."""
    out, H = total.out, total.H
    if not H:
        return
    if not build.launches_kernel(out):
        rows = out.shape[1]
        arrived = _row_views(recv, out.shape, total.s1)
        edge = None
        for k in total.order:
            own = total.own[k]
            if arrived[k] is not None:
                own[:, H - total.s1[k]:] = arrived[k]
            edge = own if edge is None else edge + own
        out[:, rows - H:] = (edge * total.scale).to(out.dtype)
        return
    _check_f32("the routed rows", recv, total.send.numel(), out.device)
    build.check_aligned("the routed rows", recv)
    _launch("ftt_windowed_nmf_slab_tail", "tail_launches", total.own, recv, out, build.dtype_code(out.dtype),
            out.shape[0], out.shape[1], out[0, 0].numel(), H, len(total.s1), (ctypes.c_int * len(total.s1))(*total.s1),
            total.scale, build.stream_of(out))


# --- the ring ------------------------------------------------------------------------------------------------------


def _travel(tensors: list, forward: bool, exchange: Exchange) -> list:
    """One exchange: every slab's tensor one step along the ring, counted."""
    windowed_nmf_multi_spatial.exchanges += 1
    windowed_nmf_multi_spatial.bytes_sent += sum(t.numel() * t.element_size() for t in tensors)
    return exchange(tensors, forward)


def _same_slabs(xs) -> None:
    if len({(x.shape[0], *x.shape[2:], x.dtype, x.device) for x in xs}) != 1:
        raise ValueError("the slabs of a ring must share one shape but for their rows, one dtype and one device")


def _forward(xs, exchange: Exchange, u0, v0, head_dim, patch, shifts, solver, num_iters, eps) -> list:
    """The forward on the slabs this process holds: a halo, pass A, the routed factors, pass B."""
    _same_slabs(xs)
    H, nothing = max(_firsts(shifts, patch)), [None] * len(xs)
    halos = _travel([x[:, x.shape[1] - H:].contiguous() for x in xs], True, exchange) if H else nothing
    factors = [windowed_nmf_slab_factors(x, h, u0, v0, head_dim, patch, shifts, solver, num_iters, eps)
               for x, h in zip(xs, halos)]
    arrived = _travel([route for *_, route in factors], False, exchange) if H else nothing
    return [windowed_nmf_slab_reconstruct(U, V, recv, x.shape, x.dtype, head_dim, patch, shifts)
            for (U, V, _), recv, x in zip(factors, arrived, xs)]


def _backward(xs, gs, exchange: Exchange, u0, v0, head_dim, patch, shifts, solver, num_iters, eps,
              grad_steps) -> list:
    """``dx`` on the slabs this process holds for their cotangents ``gs``: the halos, the passes, the routed rows,
    the tails."""
    _same_slabs(xs)
    normed = [_norm_shift(shift, patch) for shift in shifts]
    totals = [SlabSum(x, normed, not build.launches_kernel(x)) for x in xs]
    H = totals[0].H
    halos = [None] * len(xs)
    if H:
        pairs = []
        for x, g in zip(xs, gs):
            pair = x.new_empty((2, x.shape[0], H, *x.shape[2:]))
            pair[0], pair[1] = x[:, x.shape[1] - H:], g[:, g.shape[1] - H:]
            pairs.append(pair)
        halos = _travel(pairs, True, exchange)
    for k in totals[0].order:
        for x, g, h, total in zip(xs, gs, halos, totals):
            windowed_nmf_slab_backward_pass(x, g, h, total, k, u0, v0, head_dim, patch, solver, num_iters, eps,
                                            grad_steps)
    arrived = _travel([total.send for total in totals], False, exchange) if H else [None] * len(xs)
    for total, recv in zip(totals, arrived):
        windowed_nmf_slab_tail(total, recv)
    return [total.out for total in totals]


class _SpatialNMF(torch.autograd.Function):
    """The slab passes under autograd: forward saves the slabs alone; ``u0`` and ``v0`` get no gradient.

    The backward always runs every pass and every exchange, whichever inputs
    need a gradient: the processes of a ring must enter the same exchanges in
    the same order.
    """

    @staticmethod
    def forward(ctx, exchange, config, u0, v0, *slabs):
        ctx.exchange, ctx.config = exchange, config
        ctx.save_for_backward(u0, v0, *slabs)
        return tuple(_forward(slabs, exchange, u0, v0, *config[:-1]))

    @staticmethod
    def backward(ctx, *gs):
        u0, v0, *slabs = ctx.saved_tensors
        *config, num_grad_steps = ctx.config
        num_iters = config[4]
        grad_steps = num_iters if num_grad_steps is None else max(min(num_grad_steps, num_iters), 0)
        if grad_steps == 0:
            dxs = [torch.zeros_like(x) for x in slabs]  # every iteration saw a detached x
        else:
            dxs = _backward(slabs, [g.contiguous() for g in gs], ctx.exchange, u0, v0, *config, grad_steps)
        return (None, None, None, None, *dxs)


def _local_ring(tensors: list, forward: bool) -> list:
    """The ring held in one process: slab ``i`` receives from ``i - 1`` (forward) or ``i + 1``."""
    n, step = len(tensors), 1 if forward else -1
    return [tensors[(i - step) % n] for i in range(n)]


def _process_ring(tensors: list, forward: bool, mesh, axis: str) -> list:
    return [ring_exchange(t, mesh, axis, forward) for t in tensors]


def windowed_nmf_multi_spatial_local(
    slabs: Sequence[torch.Tensor],
    u0: torch.Tensor,
    v0: torch.Tensor,
    head_dim: int,
    patch: int,
    shifts: Sequence = (None,),
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
) -> list[torch.Tensor]:
    """K5 on all slabs of a ring held in one process, the exchanges wired by hand; differentiable in the slabs.

    ``slabs[i]`` is the ``i``-th slab of the volume along dim 1, contiguous;
    the slabs may hold unequal rows, each a multiple of the patch.  Every line
    but the exchange is that of :func:`windowed_nmf_multi_spatial`.
    """
    config = (head_dim, patch, tuple(shifts), solver, num_iters, eps, num_grad_steps)
    return list(_SpatialNMF.apply(_local_ring, config, u0, v0, *slabs))


def windowed_nmf_multi_spatial(
    x_local: torch.Tensor,
    u0: torch.Tensor,
    v0: torch.Tensor,
    head_dim: int,
    patch: int,
    shifts: Sequence = (None,),
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
    *,
    mesh,
    axis_name: str = "model",
) -> torch.Tensor:
    """Shifted-window NMF mixing of a volume whose first spatial axis is cut over ``axis_name`` of ``mesh``.

    ``x_local (B, L, S2, S3, C)`` is this process's slab, the
    ``mesh.axis_index(axis_name)``-th of ``mesh.axis_size(axis_name)``; ``L``
    must be a multiple of ``patch``.  Returns the mixed slab, differentiable
    in ``x_local``.  Collective over the axis, in the backward too: every
    process of the ring calls it, and calls ``backward``, in the same order.
    The slab kernels on the card, the plain passes on the CPU.
    """
    config = (head_dim, patch, tuple(shifts), solver, num_iters, eps, num_grad_steps)
    exchange = functools.partial(_process_ring, mesh=mesh, axis=axis_name)
    return _SpatialNMF.apply(exchange, config, u0, v0, x_local)[0]


# Per process: kernel launches of the forward (pass A and pass B, one each per mixer and slab), of the backward (one
# per shift and slab) and of its ordered tail (one per slab where a shift moves rows); the exchanges entered (two in
# the forward and two in the backward of a mixer whose shifts move rows) and the bytes handed to them
# (exchange_sizes: halos in the slab's dtype, routed factors and rows in f32).
windowed_nmf_multi_spatial.launches = 0
windowed_nmf_multi_spatial.backward_launches = 0
windowed_nmf_multi_spatial.tail_launches = 0
windowed_nmf_multi_spatial.exchanges = 0
windowed_nmf_multi_spatial.bytes_sent = 0


def windowed_nmf_multi_spatial_plain(
    slabs: Sequence[torch.Tensor],
    u0: torch.Tensor,
    v0: torch.Tensor,
    head_dim: int,
    patch: int,
    shifts: Sequence = (None,),
    solver: str = "hals",
    num_iters: int = 5,
    eps: float = EPS,
    num_grad_steps: Optional[int] = None,
) -> list[torch.Tensor]:
    """The plain PyTorch version of the whole ring in one process, which autograd differentiates; the slabs as
    :func:`windowed_nmf_multi_spatial_local` takes them (unequal rows too).

    Per shift and slab: concatenate the left neighbour's rows, fold and solve
    the padded slab, keep the rows ``[0, L - s1)`` and take the last ``s1``
    from the right neighbour's result; f32 mean over the shifts; cast.
    """
    n = len(slabs)
    sums = [0.0] * n
    for shift in shifts:
        s1, s2, s3 = _norm_shift(shift, patch)
        passes = []
        for i, x in enumerate(slabs):
            left = slabs[i - 1]
            ys = windowed_nmf_plain(_padded(x, left[:, left.shape[1] - s1:], s1), u0, v0, head_dim, patch,
                                    ((0, s2, s3),), solver, num_iters, eps, num_grad_steps)
            passes.append(ys)
        for i, ys in enumerate(passes):
            sums[i] = sums[i] + (torch.cat([ys[:, s1:], passes[(i + 1) % n][:, :s1]], 1) if s1 else ys)
    return [(s / len(shifts)).to(x.dtype) for s, x in zip(sums, slabs)]
