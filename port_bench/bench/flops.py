"""The FLOPs of a cell's math, counted once from the benchmark's own reference, never from the program.

``torch.utils.flop_counter.FlopCounterMode`` over the configuration's plain
reference (``ref``: its ``param_spec`` and ``forward``) on ``meta`` tensors of the timed shapes: the
matrix products and convolutions of a forward (serving: one call of
``sw_batch`` windows) or of a forward and its backward through the DiceCE loss
(training: one step).  Elementwise work, the norms and the optimiser are not
counted, as an MFU does not count them.  A later change of the program's
kernels cannot move the count.

The counter's own formula for a convolution's backward leaves out the groups
(it counts a depthwise convolution's gradients as a dense one's, C times too
many), so :func:`conv_backward_flops` replaces it: each gradient asked for
costs what the forward costs.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import train


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                        _output_padding, _groups, output_mask, out_shape=None) -> int:
    """Two FLOPs per multiply-add of the forward, once per gradient in ``output_mask`` (input, weight)."""
    if transposed:  # weight (C_in, C_out / groups, *k): every input element meets C_out / groups filters of k taps
        forward = 2 * math.prod(x_shape) * math.prod(w_shape[1:])
    else:  # weight (C_out, C_in / groups, *k): every output element sums C_in / groups filters of k taps
        forward = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _counter() -> FlopCounterMode:
    return FlopCounterMode(display=False, custom_mapping={torch.ops.aten.convolution_backward: conv_backward_flops})


def _meta_params(spec: dict) -> dict:
    return {k: torch.zeros(shape, device="meta") for k, (shape, _) in spec.items()}


def forward_flops(ref, net: dict, batch: int, roi) -> int:
    params = _meta_params(ref.param_spec(net, roi))
    x = torch.zeros((batch, net["in_channels"], *roi), device="meta")
    with _counter() as counter, torch.no_grad():
        ref.forward(params, x, net)
    return counter.get_total_flops()


def train_step_flops(ref, net: dict, batch: int, roi) -> int:
    spec = ref.param_spec(net, roi)
    params = _meta_params(spec)
    leaves = [params[k].requires_grad_(True) for k, (_, kind) in spec.items() if kind != "nonneg"]
    x = torch.zeros((batch, net["in_channels"], *roi), device="meta")
    labels = torch.zeros((batch, net["out_channels"], *roi), device="meta")
    with _counter() as counter:
        loss = train.dice_ce_loss(ref.forward(params, x, net), labels)
        torch.autograd.grad(loss, leaves)
    return counter.get_total_flops()
