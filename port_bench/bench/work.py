"""The work a kernel's call needs, counted from its shapes, and the least time the card could take for it.

Frozen copies, so that a later change of the program cannot move the
yardstick: ``PEAK_BYTES``, ``PEAK_FLOPS``, ``NUM_ITERS``, ``bound_ms``,
``k1_work``, ``k2_work`` and ``k3_work`` are ``chip_smoke.py``'s (lines
403-484 at commit ef50548), with ``dname`` beside them.  The peaks are those
of one H100 SXM at 700 W from NVIDIA's data sheet (dense rates; float64's, outside
the tensor cores, added beside them).  Each
function takes tensors for their shape and element size only: a tensor on the
``meta`` device does.

:func:`block_shapes` lists, from a configuration, the channels-last shape
``(B, *S, C)`` of every block of the U-Net at a batch and roi: the shapes at
which K1, K2 and K3 run.
"""

from __future__ import annotations

import torch

NUM_ITERS = 5

# Published peaks of one H100 SXM at 700 W: HBM bytes/s, and FLOP/s of the
# units a kernel's operations run on: f32 outside the tensor cores, dense TF32,
# bf16 and f16 in them.  A bound takes the peak of the units its kernel runs on.
PEAK_BYTES, PEAK_FLOPS = 3.35e12, {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12,
                                   "float64": 34e12}


def dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def bound_ms(n_bytes: float, flops: float, dtype, units: str | None = None) -> tuple[float, str]:
    """The least time the card could take: each input read and output written once, or the operations at the
    peak of ``units`` (default: the activations' dtype)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_FLOPS[units or dname(dtype)]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_work(x, n_shifts: int, backward: bool, grad_steps: int = NUM_ITERS, mu: bool = False) -> tuple[float, float]:
    """(bytes, flops) of K1 on ``x``, whose solve runs on the f32 CUDA cores whatever the dtype.  Per element
    and shift the solve does two mat-vecs (4 flops) per iteration and the rank-1 product and the shift sum
    (2); the backward adds the seed's two mat-vecs (4) and, per differentiated iteration, two mat-vecs and two
    rank-1 updates of dX (8; MU recomputes one more mat-vec, 10).  Forward: x read once, y written once (the
    kernels read x once per shift and write and read the f32 factors, (d + p^3) / (d p^3) of the volume per
    shift, between their two passes; the bound counts neither).  Backward: x and g read, dx written."""
    n = x.numel()
    flops = 4 * NUM_ITERS + 2
    if backward:
        flops += 4 + (10 if mu else 8) * grad_steps
    return (3 if backward else 2) * n * x.element_size(), float(n_shifts * n * flops)


def k2_work(x, hidden: int, backward: bool) -> tuple[float, float, str]:
    """(bytes, flops, units) of K2 on ``x (..., C)``: two products of 2 C H flops per token forward, five
    backward; x read and y written (backward: x and g read, dx written), the f32 parameters read (and their
    gradients written) once.  The operations are counted at the tensor cores' peak for the activations' type,
    TF32's for f32 and bf16's (f16's) for bf16 (f16), in both directions: the function's products take
    16-bit operands for 16-bit activations, as the JAX kernels' do.  The kernels' three-pass TF32 split
    (which the backward also takes for bf16 and f16, to hold its parameter gradients' band) is their own cost, not
    work the function needs, so it is not counted."""
    c = x.shape[-1]
    tokens = x.numel() // c
    n_params = 3 * c + hidden + 2 * c * hidden
    n_bytes = (3 if backward else 2) * x.numel() * x.element_size() + (2 if backward else 1) * 4 * n_params
    flops = float(tokens * (10 if backward else 4) * c * hidden)
    return n_bytes, flops, "tf32" if x.dtype == torch.float32 else dname(x.dtype)


def k3_work(x, taps: int, dw: bool) -> tuple[float, float]:
    """(bytes, flops) of K3 on ``x (B, *S, C)``: one multiply-add per tap and element.  Forward: x read, y
    written, the f32 taps read.  dw: x and g read, the f32 taps' gradient written."""
    n_taps = x.shape[0] * taps * x.shape[-1]
    return 2 * x.numel() * x.element_size() + 4 * n_taps, float(2 * taps * x.numel())


def block_shapes(net: dict, batch: int, roi) -> list[tuple]:
    """``(B, *S, C)`` of every block of the U-Net, encoder levels first, then the decoder's (deepest first)."""
    size, levels = tuple(roi), []
    for width, stride in zip(net["encoder_width"], net["strides"]):
        size = tuple(s // stride for s in size)
        levels.append((batch, *size, width))
    shapes = [lv for lv, depth in zip(levels, net["encoder_depth"]) for _ in range(depth)]
    for k, depth in enumerate(net["decoder_depth"]):
        shapes += [levels[-2 - k]] * depth
    return shapes


def meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")
