"""The plain U-Net that both reference families share, channels-last inside, in 2-D or 3-D.

The bundles' U-Net (github.com/pashtari/factorizer, ``model_zoo/*/configs/train.yaml``): a k3 p1 stem without
bias, encoder stages after a k2 stride-2 convolution, decoder stages after a k2 stride-2 transposed convolution on
the concatenation ``[skip, up]`` with a bias-free linear adapter, a k1 head.  A family's module
(``port_bench/reference/factorizer.py``, ``deconver.py``: a configuration's ``reference``) gives the tensors of its
blocks and the block itself; this module names the rest and runs the ladder.  It imports nothing of the program
under test and computes with plain ``torch`` operations, in the dtype of the tensors it is given.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-16
LN_EPS = 1e-5


def spec_name(value) -> str:
    """``"$ftx.LayerNorm"`` -> ``"LayerNorm"``: the last name of a bundle's class reference."""
    return str(value).rsplit(".", 1)[-1]


def levels(net: dict, roi: Sequence[int]) -> list[tuple[int, tuple]]:
    """``(width, spatial size)`` of each encoder level."""
    size, out = tuple(roi), []
    for width, stride in zip(net["encoder_width"], net["strides"]):
        size = tuple(s // stride for s in size)
        out.append((width, size))
    return out


def mlp_spec(prefix: str, c: int, net: dict) -> list[tuple[str, tuple, str]]:
    hidden = int(net["mlp_ratio"] * c)
    return [(f"{prefix}mlp.block.0.linear.weight", (hidden, c), "weight"),
            (f"{prefix}mlp.block.0.linear.bias", (hidden,), "bias"),
            (f"{prefix}mlp.block.3.linear.weight", (c, hidden), "weight"),
            (f"{prefix}mlp.block.3.linear.bias", (c,), "bias")]


def param_spec(net: dict, roi: Sequence[int], block_spec: Callable, pos_embed: bool) -> "OrderedDict":
    """Every tensor the network holds, in the program's order: name -> (shape, kind).

    ``block_spec(prefix, c, net)`` lists a block's tensors; ``pos_embed`` adds the bottleneck's learned positional
    embedding.  ``kind`` says how the benchmark draws it (:mod:`port_bench.bench.weights`): ``weight`` and ``bias``
    (a bias pairs with the weight of its layer), ``norm_weight`` / ``norm_bias``, ``nonneg`` (NMF starting
    factors) and ``normal`` (the positional embedding)."""
    n = len(roi)
    lv = levels(net, roi)
    spec: list = [("stem.weight", (net["encoder_width"][0], net["in_channels"], *(3,) * n), "weight")]
    widths = [net["encoder_width"][0], *net["encoder_width"]]
    for i, (c, size) in enumerate(lv):
        if net["strides"][i] != 1:
            spec += [(f"encoder.blocks.{i}.downsample.weight", (c, widths[i], *(2,) * n), "weight"),
                     (f"encoder.blocks.{i}.downsample.bias", (c,), "bias")]
        if pos_embed and i == len(lv) - 1:
            spec.append((f"encoder.blocks.{i}.block.pos_embed.pos", (1, c, *size), "normal"))
        for j in range(net["encoder_depth"][i]):
            spec += block_spec(f"encoder.blocks.{i}.block.blocks.{j}.", c, net)
    dec = list(net["encoder_width"][::-1])
    for k in range(len(net["decoder_depth"])):
        c_in, c = dec[k], dec[k + 1]
        spec += [(f"decoder.blocks.{k}.upsample.weight", (c_in, c, *(2,) * n), "weight"),
                 (f"decoder.blocks.{k}.upsample.bias", (c,), "bias"),
                 (f"decoder.blocks.{k}.block.adapter.linear.weight", (c, 2 * c), "weight")]
        for j in range(net["decoder_depth"][k]):
            spec += block_spec(f"decoder.blocks.{k}.block.blocks.{j}.", c, net)
    spec += [("head.weight", (net["out_channels"], net["encoder_width"][0], *(1,) * n), "weight"),
             ("head.bias", (net["out_channels"],), "bias")]
    return OrderedDict((name, (shape, kind)) for name, shape, kind in spec)


# -- layers on channels-last tensors (B, *S, C)

def linear(x, p, name, bias=True):
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias") if bias else None)


def conv_nd(x, w, b=None, stride=1, padding=0, groups=1):
    """``x (B, *S, C)`` through F.conv2d / conv3d by the weight's rank, channels-last in and out."""
    fn = {4: F.conv2d, 5: F.conv3d}[w.ndim]
    return fn(x.movedim(-1, 1), w, b, stride, padding, 1, groups).movedim(1, -1)


def _conv_transpose(x, w, b, stride=2):
    fn = {4: F.conv_transpose2d, 5: F.conv_transpose3d}[w.ndim]
    return fn(x.movedim(-1, 1), w, b, stride).movedim(1, -1).contiguous()


def layer_norm(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.norm.weight"], p[f"{name}.norm.bias"], LN_EPS)


def instance_norm(x):
    """Each channel of each sample over its spatial extent, no affine (eps 1e-5)."""
    axes = tuple(range(1, x.ndim - 1))
    var, mean = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS)


def mlp(x, p, prefix):
    h = F.gelu(linear(x, p, f"{prefix}mlp.block.0.linear"))
    return linear(h, p, f"{prefix}mlp.block.3.linear")


def _stage(x, p, prefix, depth, net, block):
    if f"{prefix}adapter.linear.weight" in p:
        x = linear(x, p, f"{prefix}adapter.linear", bias=False)
    if f"{prefix}pos_embed.pos" in p:
        x = x + p[f"{prefix}pos_embed.pos"].movedim(1, -1)
    for j in range(depth):
        x = block(x, p, f"{prefix}blocks.{j}.", net)
    return x


def forward(p: dict, x: torch.Tensor, net: dict, block: Callable) -> torch.Tensor:
    """Logits ``(B, C_out, *S)`` of the U-Net with blocks ``block(x, p, prefix, net)`` on ``x (B, C_in, *S)``."""
    t = conv_nd(x.movedim(1, -1), p["stem.weight"], None, 1, 1).contiguous()
    skips = []
    for i, stride in enumerate(net["strides"]):
        if stride != 1:
            w, b = p[f"encoder.blocks.{i}.downsample.weight"], p[f"encoder.blocks.{i}.downsample.bias"]
            t = conv_nd(t, w, b, stride).contiguous()
        t = _stage(t, p, f"encoder.blocks.{i}.block.", net["encoder_depth"][i], net, block)
        skips.append(t)
    for k, depth in enumerate(net["decoder_depth"]):
        up = _conv_transpose(t, p[f"decoder.blocks.{k}.upsample.weight"], p[f"decoder.blocks.{k}.upsample.bias"])
        t = _stage(torch.cat([skips[-2 - k], up], dim=-1), p, f"decoder.blocks.{k}.block.", depth, net, block)
    logits = F.linear(t, p["head.weight"].flatten(1), p["head.bias"])
    return logits.movedim(-1, 1)

