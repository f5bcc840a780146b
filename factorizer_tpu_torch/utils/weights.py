"""Weight bridge: the JAX package's Flax variables -> this port's ``state_dict``.

The inverse of ``factorizer_tpu/utils/torch_import.py::convert_state_dict``.
It takes ``{"params": ..., "buffers": ...}`` as nested dicts of numpy arrays
and undoes the layout changes that ``convert_state_dict`` makes:

* conv kernel ``(*k, I, O)``            -> weight ``(O, I, *k)``
* transposed-conv kernel ``(*k, I, O)`` -> weight ``(I, O, *k)``, un-flipped spatially
* Dense kernel ``(I, O)``               -> Linear weight ``(O, I)``
* LayerNorm ``scale``                   -> ``weight``
* positional embedding ``(1, *S, C)``   -> ``(1, C, *S)``
* NMF tables u0 / v0                    -> buffers ``factorize.init.u0`` / ``.v0``
* Deconv ``h0`` and its ``linear`` head -> ``deconv.init.h0`` / ``deconv.init.linear``

Convolutions of either rank (2-D images, 3-D volumes) go through the same rules.

So ``convert_state_dict(model.state_dict())`` reproduces the variables leaf for leaf.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["load_flax_variables", "flax_path"]

Transform = Optional[Callable[[np.ndarray], np.ndarray]]


def _conv_weight(k: np.ndarray) -> np.ndarray:
    nd = k.ndim - 2
    return np.transpose(k, (nd + 1, nd, *range(nd)))


def _tconv_weight(k: np.ndarray) -> np.ndarray:
    nd = k.ndim - 2
    unflipped = k[(slice(None, None, -1),) * nd]
    return np.transpose(unflipped, (nd, nd + 1, *range(nd)))


def _linear_weight(k: np.ndarray) -> np.ndarray:
    return k.T


def _pos_embed(p: np.ndarray) -> np.ndarray:
    return np.moveaxis(p, -1, 1)


# Port key (regex) -> (Flax path template, transform).  "{0}", "{1}" are the
# regex groups; a "buffers:" prefix selects that collection.  Stage rules
# apply below "encoder|decoder.blocks.{i}.block." -> "unet.enc|dec{i}.".
_TOP_RULES: list[tuple[str, str, Transform]] = [
    (r"stem\.weight", "unet.stem.conv.kernel", _conv_weight),
    (r"stem\.bias", "unet.stem.conv.bias", None),
    (r"encoder\.blocks\.(\d+)\.downsample\.weight", "unet.down{0}.conv.kernel", _conv_weight),
    (r"encoder\.blocks\.(\d+)\.downsample\.bias", "unet.down{0}.conv.bias", None),
    (r"decoder\.blocks\.(\d+)\.upsample\.weight", "unet.up{0}.conv.kernel", _tconv_weight),
    (r"decoder\.blocks\.(\d+)\.upsample\.bias", "unet.up{0}.conv.bias", None),
    (r"head\.weight", "unet.head.conv.kernel", _conv_weight),
    (r"head\.bias", "unet.head.conv.bias", None),
]
_STAGE_RULES: list[tuple[str, str, Transform]] = [
    (r"adapter\.linear\.weight", "adapter_.linear.kernel", _linear_weight),
    (r"pos_embed\.pos", "pos_embed_.pos", _pos_embed),
    (r"blocks\.(\d+)\.norm(\d)\.norm\.weight", "block{0}.norm{1}.norm.scale", None),
    (r"blocks\.(\d+)\.norm(\d)\.norm\.bias", "block{0}.norm{1}.norm.bias", None),
    (r"blocks\.(\d+)\.fact\.(in_proj|out_proj)\.linear\.weight", "block{0}.fact.{1}.linear.kernel", _linear_weight),
    (r"blocks\.(\d+)\.fact\.out_proj\.linear\.bias", "block{0}.fact.out_proj.linear.bias", None),
    (r"blocks\.(\d+)\.fact\.factorize\.init\.(u0|v0)", "buffers:block{0}.fact.factorize_op.initializer.{1}", None),
    (r"blocks\.(\d+)\.dcm\.(in_proj|out_proj)\.linear\.weight", "block{0}.dcm.{1}.linear.kernel", _linear_weight),
    (r"blocks\.(\d+)\.dcm\.out_proj\.linear\.bias", "block{0}.dcm.out_proj.linear.bias", None),
    (r"blocks\.(\d+)\.dcm\.deconv\.init\.h0", "block{0}.dcm.deconv.h0", None),
    (r"blocks\.(\d+)\.dcm\.deconv\.init\.linear\.linear\.weight", "block{0}.dcm.deconv.linear.linear.kernel", _linear_weight),
    (r"blocks\.(\d+)\.dcm\.deconv\.init\.linear\.linear\.bias", "block{0}.dcm.deconv.linear.linear.bias", None),
    # MLP Sequential: block.0 = fc1, block.3 = fc2
    (r"blocks\.(\d+)\.mlp\.block\.0\.linear\.weight", "block{0}.mlp.fc1.linear.kernel", _linear_weight),
    (r"blocks\.(\d+)\.mlp\.block\.0\.linear\.bias", "block{0}.mlp.fc1.linear.bias", None),
    (r"blocks\.(\d+)\.mlp\.block\.3\.linear\.weight", "block{0}.mlp.fc2.linear.kernel", _linear_weight),
    (r"blocks\.(\d+)\.mlp\.block\.3\.linear\.bias", "block{0}.mlp.fc2.linear.bias", None),
]


def _fill(template: str, groups: tuple[str, ...]) -> str:
    for i, g in enumerate(groups):
        template = template.replace(f"{{{i}}}", g)
    return template


def flax_path(key: str) -> tuple[str, tuple[str, ...], Transform]:
    """``(collection, path, transform)`` of the Flax leaf behind port state-dict ``key``."""
    m = re.fullmatch(r"(encoder|decoder)\.blocks\.(\d+)\.block\.(.+)", key)
    if m:
        prefix = f"unet.{'enc' if m.group(1) == 'encoder' else 'dec'}{m.group(2)}."
        rules, rest = _STAGE_RULES, m.group(3)
    else:
        prefix, rules, rest = "", _TOP_RULES, key
    for pattern, template, fn in rules:
        mm = re.fullmatch(pattern, rest)
        if mm is None:
            continue
        path = _fill(template, mm.groups())
        collection = "params"
        if path.startswith("buffers:"):
            collection, path = "buffers", path[len("buffers:") :]
        return collection, tuple((prefix + path).split(".")), fn
    raise KeyError(f"no Flax counterpart for state-dict key {key!r}")


def _get(tree: Mapping[str, Any], path: tuple[str, ...]) -> np.ndarray:
    node: Any = tree
    for p in path:
        node = node[p]
    return np.asarray(node)


def load_flax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Load the JAX package's ``{"params", "buffers"}`` variables into ``model`` in place.

    Every entry of ``model.state_dict()`` must have a counterpart; shapes are checked.
    """
    state = model.state_dict()
    new_state = {}
    for key, current in state.items():
        collection, path, fn = flax_path(key)
        value = _get(variables[collection], path)
        if fn is not None:
            value = fn(value)
        if tuple(value.shape) != tuple(current.shape):
            raise ValueError(f"{key}: Flax leaf {'.'.join(path)} has shape {value.shape}, expected {tuple(current.shape)}")
        new_state[key] = torch.tensor(np.ascontiguousarray(value)).to(current.dtype)
    model.load_state_dict(new_state, strict=True)
    return model
