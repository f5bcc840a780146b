"""Plain PyTorch reference of the Swin-Factorizer (a configuration's ``"reference"``), channels-last, 2-D or 3-D.

Ashtari et al., "Factorizer: A scalable interpretable approach to context modeling for medical image
segmentation", MedIA 2023, as the reference bundles configure it (github.com/pashtari/factorizer,
``model_zoo/factorizer_*/configs/train.yaml``), on the U-Net of :mod:`port_bench.reference.unet`:

* block: ``x + out_proj(nmf(relu(in_proj(ln1(x)))))``, then ``x + fc2(gelu(fc1(ln2(x))))``; the bottleneck
  stage adds a learned positional embedding after its downsampling;
* ``nmf``: the mean over the shifts of shifted-window rank-1 NMF: roll by the shift, cut the volume into
  ``p^n`` windows and ``C / d`` heads as ``d x p^n`` matrices, run ``num_iters`` HALS updates (U first) from the
  shared starting factors ``u0`` / ``v0``, reconstruct, un-roll.

Departures from the published description, shared with the program so that the two compute one function: the NMF
regulariser ``eps = 1e-16`` sits in numerator and denominator of each HALS quotient, ``relu((a + eps) / (b +
eps))``; a shift is taken modulo the patch (the reference code's ``torch.roll`` of whole windows); the solve runs in
the activations' type here (float32 in every cell).
"""

from __future__ import annotations

from typing import Sequence

import torch

from port_bench.reference import unet
from port_bench.reference.unet import EPS, spec_name


def check_supported(net: dict) -> None:
    """Raise on a ``network_def`` setting that this reference does not compute."""
    if net["_target_"] != "Factorizer":
        raise NotImplementedError(f"this reference computes the Factorizer, not {net['_target_']}")
    if net.get("act", "relu") != "relu":
        raise NotImplementedError(f"act={net['act']!r}")
    if spec_name(net["reshape"][0]) != "SWMatricize" or spec_name(net.get("factorize", "NMF")) != "NMF":
        raise NotImplementedError("the Factorizer reference covers SWMatricize and NMF")
    if net.get("rank") != 1 or net.get("solver") != "hals" or net.get("init_method") != "uniform":
        raise NotImplementedError("the Factorizer reference covers rank-1 HALS from a uniform init")
    if net.get("num_grad_steps") is not None or spec_name(net.get("norm")) != "LayerNorm":
        raise NotImplementedError("the Factorizer reference covers num_grad_steps None and LayerNorm")


def _block_spec(prefix: str, c: int, net: dict, n: int) -> list:
    d, p = net["reshape"][1]["head_dim"], net["reshape"][1]["patch_size"]
    return [(f"{prefix}norm1.norm.weight", (c,), "norm_weight"), (f"{prefix}norm1.norm.bias", (c,), "norm_bias"),
            (f"{prefix}fact.in_proj.linear.weight", (c, c), "weight"),
            (f"{prefix}fact.factorize.init.u0", (d, 1), "nonneg"),
            (f"{prefix}fact.factorize.init.v0", (p ** n, 1), "nonneg"),
            (f"{prefix}fact.out_proj.linear.weight", (c, c), "weight"),
            (f"{prefix}fact.out_proj.linear.bias", (c,), "bias"),
            (f"{prefix}norm2.norm.weight", (c,), "norm_weight"), (f"{prefix}norm2.norm.bias", (c,), "norm_bias"),
            *unet.mlp_spec(prefix, c, net)]


def param_spec(net: dict, roi: Sequence[int]):
    """Every tensor the network holds, in order: name -> (shape, kind) (:func:`port_bench.reference.unet.param_spec`)."""
    check_supported(net)
    n = len(roi)
    return unet.param_spec(net, roi, lambda prefix, c, net_: _block_spec(prefix, c, net_, n), pos_embed=True)


# -- shifted-window rank-1 NMF

def _fold(x, d, p):
    """``(B, S1, ..., Sn, C)`` -> ``(B * C/d, windows, d, p^n)``."""
    b, *sizes, c = x.shape
    n = len(sizes)
    x = x.reshape(b, *(v for s in sizes for v in (s // p, p)), c // d, d)
    order = (0, 2 * n + 1, *range(1, 2 * n, 2), 2 * n + 2, *range(2, 2 * n + 1, 2))
    return x.permute(order).reshape(b * (c // d), -1, d, p ** n)


def _unfold(y, shape, d, p):
    b, *sizes, c = shape
    n = len(sizes)
    y = y.reshape(b, c // d, *(s // p for s in sizes), d, *(p,) * n)
    order = (0, *(v for i in range(n) for v in (2 + i, 3 + n + i)), 1, 2 + n)
    return y.permute(order).reshape(tuple(shape))


def _hals_rank1(m, u0, v0, num_iters):
    u = u0.expand(*m.shape[:-2], *u0.shape)
    v = v0.expand(*m.shape[:-2], *v0.shape)
    for _ in range(num_iters):
        u = torch.relu((m @ v + EPS) / (v.transpose(-1, -2) @ v + EPS))
        v = torch.relu((m.transpose(-1, -2) @ u + EPS) / (u.transpose(-1, -2) @ u + EPS))
    return u, v


def shifted_window_nmf(x, u0, v0, head_dim, patch, shifts, num_iters):
    """The mean over ``shifts`` of ``roll(-s, unfold(u v^T))`` for the rank-1 HALS factors of ``fold(roll(s, x))``."""
    axes = tuple(range(1, x.ndim - 1))
    acc = None
    for shift in shifts:
        s = 0 if shift is None else int(shift) % patch
        xs = torch.roll(x, (s,) * len(axes), axes) if s else x
        u, v = _hals_rank1(_fold(xs, head_dim, patch), u0, v0, num_iters)
        ys = _unfold(u @ v.transpose(-1, -2), x.shape, head_dim, patch)
        if s:
            ys = torch.roll(ys, (-s,) * len(axes), axes)
        acc = ys if acc is None else acc + ys
    return acc / len(shifts)


def _block(x, p, prefix, net):
    sw = net["reshape"][1]
    y = torch.relu(unet.linear(unet.layer_norm(x, p, f"{prefix}norm1"), p, f"{prefix}fact.in_proj.linear", bias=False))
    y = shifted_window_nmf(y, p[f"{prefix}fact.factorize.init.u0"], p[f"{prefix}fact.factorize.init.v0"],
                           sw["head_dim"], sw["patch_size"], sw["shifts"], net["num_iters"])
    x = x + unet.linear(y, p, f"{prefix}fact.out_proj.linear")
    return x + unet.mlp(unet.layer_norm(x, p, f"{prefix}norm2"), p, prefix)


def forward(p: dict, x: torch.Tensor, net: dict) -> torch.Tensor:
    """Logits ``(B, C_out, *S)`` of the network ``net`` with the tensors ``p`` on ``x (B, C_in, *S)``."""
    return unet.forward(p, x, net, _block)
