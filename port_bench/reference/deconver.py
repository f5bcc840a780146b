"""Plain PyTorch reference of the Deconver (a configuration's ``"reference"``), channels-last, 2-D or 3-D.

The blind-deconvolution mixer of the Factorizer's authors, as the reference bundles configure it
(github.com/pashtari/factorizer, ``model_zoo/deconver_*/configs/train.yaml``), on the U-Net of
:mod:`port_bench.reference.unet`:

* block: ``x + out_proj(deconv(relu(in_proj(in1(x)))))``, then ``x + fc2(gelu(fc1(in2(x))))`` with
  affine-free instance norms;
* ``deconv``: depthwise blind deconvolution: the source ``s = relu(linear(x))`` and the filter ``h = relu(h0)``,
  ``num_iters`` multiplicative source updates ``s * (x (*) h~ + eps) / ((s * h) (*) h~ + eps)`` with ``*`` the
  "same" depthwise cross-correlation and ``h~`` the spatially flipped filter (``eps = 1e-16``, as the program).
"""

from __future__ import annotations

from typing import Sequence

import torch

from port_bench.reference import unet
from port_bench.reference.unet import EPS, spec_name


def check_supported(net: dict) -> None:
    """Raise on a ``network_def`` setting that this reference does not compute."""
    if net["_target_"] != "Deconver":
        raise NotImplementedError(f"this reference computes the Deconver, not {net['_target_']}")
    if net.get("act", "relu") != "relu":
        raise NotImplementedError(f"act={net['act']!r}")
    if net.get("groups") != -1 or net.get("ratio") != 1 or spec_name(net.get("norm")) != "InstanceNorm":
        raise NotImplementedError("the Deconver reference covers depthwise (groups -1, ratio 1) and InstanceNorm")
    if net.get("num_grad_iters") is not None:
        raise NotImplementedError("the Deconver reference covers num_grad_iters None")


def _block_spec(prefix: str, c: int, net: dict) -> list:
    ks = tuple(net["kernel_size"])
    return [(f"{prefix}dcm.in_proj.linear.weight", (c, c), "weight"),
            (f"{prefix}dcm.deconv.init.h0", (c, 1, *ks), "weight"),
            (f"{prefix}dcm.deconv.init.linear.linear.weight", (c, c), "weight"),
            (f"{prefix}dcm.deconv.init.linear.linear.bias", (c,), "bias"),
            (f"{prefix}dcm.out_proj.linear.weight", (c, c), "weight"),
            (f"{prefix}dcm.out_proj.linear.bias", (c,), "bias"),
            *unet.mlp_spec(prefix, c, net)]


def param_spec(net: dict, roi: Sequence[int]):
    """Every tensor the network holds, in order: name -> (shape, kind) (:func:`port_bench.reference.unet.param_spec`)."""
    check_supported(net)
    if len(net["kernel_size"]) != len(roi):
        raise ValueError(f"kernel_size {net['kernel_size']} against a {len(roi)}-D roi")
    return unet.param_spec(net, roi, _block_spec, pos_embed=False)


def depthwise_deconv(x, s, h, num_iters):
    """``num_iters`` multiplicative source updates of depthwise blind deconvolution; ``h (C, 1, *k)``."""
    c, ks = x.shape[-1], h.shape[2:]
    pad = tuple(k // 2 for k in ks)
    h_adj = h.flip(tuple(range(2, h.ndim)))

    def conv(t, w):
        return unet.conv_nd(t, w, None, 1, pad, groups=c)

    for _ in range(num_iters):
        s = s * (conv(x, h_adj) + EPS) / (conv(conv(s, h), h_adj) + EPS)
    return s


def _block(x, p, prefix, net):
    y = torch.relu(unet.linear(unet.instance_norm(x), p, f"{prefix}dcm.in_proj.linear", bias=False))
    s = torch.relu(unet.linear(y, p, f"{prefix}dcm.deconv.init.linear.linear"))
    s = depthwise_deconv(y, s, torch.relu(p[f"{prefix}dcm.deconv.init.h0"]), net["num_iters"])
    x = x + unet.linear(s, p, f"{prefix}dcm.out_proj.linear")
    return x + unet.mlp(unet.instance_norm(x), p, prefix)


def forward(p: dict, x: torch.Tensor, net: dict) -> torch.Tensor:
    """Logits ``(B, C_out, *S)`` of the network ``net`` with the tensors ``p`` on ``x (B, C_in, *S)``."""
    return unet.forward(p, x, net, _block)
