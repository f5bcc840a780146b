"""K3: per-sample depthwise convolution and its weight gradient (``csrc/depthwise_conv.cu``, ``csrc/depthwise_conv_dw.cu``).

Counterpart of ``depthwise_conv3d_packed`` / ``depthwise_conv2d_packed`` in
``factorizer_tpu/ops/pallas/depthwise_packed.py`` and of ``depthwise_conv3d``
in ``factorizer_tpu/ops/pallas/depthwise_conv.py``, which compute one
function in two TPU layouts: on a channels-last volume ``x (B, S1, S2, S3, C)``
or image batch ``x (B, S1, S2, C)`` with per-sample taps ``w (B, taps, C)``,

    y[b, v, c] = sum_t w[b, t, c] * xpad[b, v + off_t, c]

with zero "same" padding, odd kernel sizes ``ks``, taps row-major over ``ks``
and cross-correlation orientation (as ``F.conv3d``).  Any channel count, any
odd ``ks``; the 2-D case runs as the ``(B, 1, S1, S2, C)`` view with kernel
``(1, k1, k2)``.

:func:`depthwise_conv` launches the forward kernel for a CUDA tensor and is
differentiable in ``x`` and ``w``: its backward launches the forward kernel on
the cotangent with spatially flipped taps (``dx``) and the weight-gradient
kernel (:func:`depthwise_conv_dw`), which sums per-block partial sums in block
order, so a gradient is the same from run to run.  A CPU tensor takes
:func:`depthwise_conv_plain`, a grouped ``F.conv{2,3}d`` that autograd
differentiates; :func:`depthwise_conv_dw_plain` is its weight gradient by name.
Both kernels accumulate in float32 for float32 or bfloat16 activations; the
taps and their gradient are float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from . import build

__all__ = ["depthwise_conv", "depthwise_conv_plain", "depthwise_conv_dw", "depthwise_conv_dw_plain", "flip_taps"]

# Kernel sizes along the innermost axis that the run kernels are compiled for; other odd sizes take
# the one-output-per-thread kernels.  ``_RUN``, ``_WARPS`` and ``_ROWS`` mirror ``csrc/depthwise_conv*.cu``.
_RUN_K3 = (1, 3, 5, 7)
_RUN, _WARPS, _ROWS = 8, 8, 9
_GRID_YZ = 65535


def _check_ks(x: torch.Tensor, ks: Sequence[int]) -> tuple[int, ...]:
    ks = tuple(int(k) for k in ks)
    if x.ndim not in (4, 5) or len(ks) != x.ndim - 2:
        raise ValueError(f"expected (B, S1, S2, C) or (B, S1, S2, S3, C) and a kernel size per spatial axis, "
                         f"got shape {tuple(x.shape)} and ks {ks}")
    if any(k < 1 or k % 2 == 0 for k in ks):
        raise ValueError(f"'same' padding needs odd kernel sizes, got {ks}")
    return ks


def flip_taps(w: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """The taps ``(B, taps, C)`` flipped along every kernel axis: the adjoint correlation's taps."""
    b, taps, c = w.shape
    return w.reshape(b, *ks, c).flip(tuple(range(1, 1 + len(ks)))).reshape(b, taps, c)


def depthwise_conv_plain(x: torch.Tensor, w: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """The plain PyTorch version: one grouped convolution over the ``(1, B*C, *S)`` view, in float32
    (float64 stays float64, for semantic checks), cast back to ``x``'s dtype."""
    ks = _check_ks(x, ks)
    b, *spatial, c = x.shape
    if tuple(w.shape) != (b, math.prod(ks), c):
        raise ValueError(f"taps of shape {(b, math.prod(ks), c)} expected, got {tuple(w.shape)}")
    dt = torch.promote_types(x.dtype, torch.float32)
    conv = F.conv2d if len(ks) == 2 else F.conv3d
    xs = x.to(dt).movedim(-1, 1).reshape(1, b * c, *spatial)
    weight = w.to(dt).transpose(1, 2).reshape(b * c, 1, *ks)
    y = conv(xs, weight, None, 1, tuple(k // 2 for k in ks), 1, b * c)
    return y.reshape(b, c, *spatial).movedim(1, -1).contiguous().to(x.dtype)


def depthwise_conv_dw_plain(x: torch.Tensor, g: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """``dw (B, taps, C)`` for the cotangent ``g`` of the output: autograd through :func:`depthwise_conv_plain`."""
    ks = _check_ks(x, ks)
    dt = torch.promote_types(x.dtype, torch.float32)
    with torch.enable_grad():
        w = torch.zeros(x.shape[0], math.prod(ks), x.shape[-1], dtype=dt, device=x.device, requires_grad=True)
        y = depthwise_conv_plain(x.detach().to(dt), w, ks)
        (dw,) = torch.autograd.grad(y, w, g.to(dt))
    return dw


def _as_volume(x: torch.Tensor, ks: tuple[int, ...]) -> tuple[tuple[int, ...], tuple[int, int, int]]:
    """``(B, S1, S2, S3, C)`` and ``(k1, k2, k3)`` as the kernels take them; 2-D gets a unit leading axis."""
    b, *spatial, c = x.shape
    if len(ks) == 2:
        spatial, ks = [1, *spatial], (1, *ks)
    if math.prod(spatial) >= 2**31 or b > _GRID_YZ:
        raise ValueError(f"the kernels take fewer than 2^31 voxels per sample and a batch up to {_GRID_YZ}")
    return (b, *spatial, c), ks


def _check_tensor(t: torch.Tensor, like: torch.Tensor, name: str) -> None:
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor of x's shape, dtype and device")


def _launch_forward(x: torch.Tensor, w: torch.Tensor, ks: tuple[int, ...]) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    shape, ks3 = _as_volume(x, ks)
    if tuple(w.shape) != (shape[0], math.prod(ks), shape[-1]) or w.device != x.device:
        raise ValueError(f"taps of shape {(shape[0], math.prod(ks), shape[-1])} on {x.device} expected, "
                         f"got {tuple(w.shape)} on {w.device}")
    wf = w.detach().float().contiguous()
    y = torch.empty_like(x)
    status = build.library().ftt_depthwise_conv(
        x.data_ptr(), wf.data_ptr(), y.data_ptr(), build.dtype_code(x.dtype), *shape, *ks3, build.stream_of(x),
    )
    build.check(status, "depthwise_conv")
    depthwise_conv.launches += 1
    return y


def depthwise_conv_dw(x: torch.Tensor, g: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """``dw (B, taps, C)``, float32, of :func:`depthwise_conv` for the cotangent ``g``.

    The weight-gradient kernel on the card, plain on the CPU.  ``g`` has
    ``x``'s shape and dtype.
    """
    ks = _check_ks(x, ks)
    if not build.launches_kernel(x):
        return depthwise_conv_dw_plain(x, g, ks)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _check_tensor(g, x, "g")
    shape, ks3 = _as_volume(x, ks)
    b, s1, s2, s3, c = shape
    taps = math.prod(ks)
    # Blocks per sample: enough to fill the card a few times over, at most one per group of work items.
    if ks3[2] in _RUN_K3:
        items, per_sample = s1 * s2 * -(-s3 // _RUN), -(-ks3[0] * ks3[1] // _ROWS)
    else:
        items, per_sample = s1 * s2 * s3, taps
    if b * per_sample > _GRID_YZ:
        raise ValueError(f"batch {b} with kernel {ks} exceeds the weight-gradient kernel's grid")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    lanes = -(-c // 32)
    blocks = max(1, min(-(-items // _WARPS), -(-4 * sms // (lanes * b * per_sample))))
    partials = torch.empty(b, blocks, taps, c, dtype=torch.float32, device=x.device)
    dw = torch.empty(b, taps, c, dtype=torch.float32, device=x.device)
    status = build.library().ftt_depthwise_conv_dw(
        x.data_ptr(), g.data_ptr(), partials.data_ptr(), dw.data_ptr(), build.dtype_code(x.dtype),
        *shape, *ks3, blocks, build.stream_of(x),
    )
    build.check(status, "depthwise_conv_dw")
    depthwise_conv_dw.launches += 1
    return dw


depthwise_conv_dw.launches = 0


class _DepthwiseConv(torch.autograd.Function):
    """The kernels under autograd: forward saves ``x`` and ``w``; ``dx`` is the forward kernel on flipped taps."""

    @staticmethod
    def forward(ctx, x, w, ks):
        ctx.save_for_backward(x, w)
        ctx.ks = ks
        return _launch_forward(x, w, ks)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        _check_tensor(g, x, "the cotangent")
        dx = _launch_forward(g, flip_taps(w, ctx.ks), ctx.ks) if ctx.needs_input_grad[0] else None
        dw = depthwise_conv_dw(x, g, ctx.ks).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, ks: Sequence[int]) -> torch.Tensor:
    """Depthwise "same" correlation of ``x (B, *S, C)`` with per-sample taps ``w (B, taps, C)``; K3 on the
    card, plain on the CPU.

    Returns a tensor of ``x``'s shape and dtype, differentiable in ``x`` and
    ``w``.  ``launches`` counts the forward kernel's launches, those that
    compute ``dx`` in a backward pass included.
    """
    ks = _check_ks(x, ks)
    if not build.launches_kernel(x):
        return depthwise_conv_plain(x, w, ks)
    return _DepthwiseConv.apply(x, w, ks)


depthwise_conv.launches = 0
