"""Weight bridge: the JAX package's Flax variables -> this port's ``state_dict``.

The inverse of ``factorizer_tpu/utils/torch_import.py::convert_state_dict``.
It takes ``{"params": ..., "buffers": ...}`` as nested dicts of numpy arrays
and undoes the layout changes that ``convert_state_dict`` makes:

* conv kernel ``(*k, I, O)``            -> weight ``(O, I, *k)``
* transposed-conv kernel ``(*k, I, O)`` -> weight ``(I, O, *k)``, un-flipped spatially
* Dense kernel ``(I, O)``               -> Linear weight ``(O, I)``
* LayerNorm ``scale``                   -> ``weight``
* positional embedding ``(1, *S, C)``   -> ``(1, C, *S)``; the axial tables ``pe{i}`` alike
* NMF tables u0 / v0                    -> buffers ``factorize.init.u0`` / ``.v0`` (a ``RandomInit`` of either
  method or a pair of them; a mixer without tables, an SVD init or ``SVD``, maps nothing)
* Deconv ``h0`` and its ``linear`` head -> ``deconv.init.h0`` / ``deconv.init.linear``

Convolutions of either rank (2-D images, 3-D volumes) go through the same rules.

So ``convert_state_dict(model.state_dict())`` reproduces the variables leaf for leaf.
:func:`flax_leaf_shapes` undoes the layouts on the shapes alone: the Flax leaf's shape of each parameter, which
JAX's sharding rule judges (``parallel.sharding.param_sharding_rules``).

Those rules serve the stages of the models laid out as the reference torch
model (``Factorizer``, ``Deconver``).  Every other module of the port (the
U-Net skeleton, the generic ``UNet``'s stage blocks, the baselines
``DynUNet``, ``SegResNet``, ``SwinUNETR``, ``UNETR``, the conv blocks and their
parts) names its submodules after the Flax modules, up to the renames below,
so a leaf's Flax path is its module path and a name given by the layer's class:

* ``Conv`` / ``ConvTranspose`` at ``P``  -> ``P.conv.kernel`` / ``P.conv.bias`` (layouts as above)
* ``Dense`` or ``nn.Linear`` at ``P``     -> ``P.kernel`` (transposed; a DenseGeneral's axes folded) / ``P.bias``
* a norm at ``P`` (LayerNorm, GroupNorm, an InstanceNorm's or GroupNorm's inner ``norm``) -> ``P.scale`` / ``P.bias``
* any other parameter                    -> its own path (``rel_pos_bias``, ``pos_embed``)

The renames: a U-Net's ``stem``, ``encoder.blocks.{i}.downsample`` /
``.block``, ``decoder.blocks.{i}.upsample`` / ``.block`` and ``head`` /
``head{j}`` are the Flax ``stem``, ``down{i}`` / ``enc{i}``, ``up{i}`` /
``dec{i}`` and ``head`` / ``head{j}``, under ``unet`` in a Factorizer or a
Deconver (``UNet.flax_prefix``); a stage's ``adapter`` is ``adapter_``; an
MLP's ``block.0`` / ``block.3`` are ``fc1`` / ``fc2``.  The bridge checks that
every entry of the state dict has a Flax leaf, and outside the Factorizer and
the Deconver that every Flax parameter is used.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .helpers import materialize

__all__ = ["load_flax_variables", "flax_state_dict", "flax_path", "flax_leaf_paths", "flax_leaf_shapes"]

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


# Port key (regex) -> (Flax path template, transform) inside a Factorizer or Deconver stage.  "{0}", "{1}" are the
# regex groups; a "buffers:" prefix selects that collection.  They apply below "encoder|decoder.blocks.{i}.block." ->
# "unet.enc|dec{i}.".
_STAGE_RULES: list[tuple[str, str, Transform]] = [
    (r"adapter\.linear\.weight", "adapter_.linear.kernel", _linear_weight),
    (r"pos_embed\.pos", "pos_embed_.pos", _pos_embed),
    (r"pos_embed\.(pe\d+)", "pos_embed_.{0}", _pos_embed),
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


def flax_path(key: str, prefix: str = "unet.") -> tuple[str, tuple[str, ...], Transform]:
    """``(collection, path, transform)`` of the Flax leaf behind ``key`` of a Factorizer or Deconver stage
    (``encoder|decoder.blocks.{i}.block. ...``), by the stage rules; KeyError where no rule matches."""
    m = re.fullmatch(r"(encoder|decoder)\.blocks\.(\d+)\.block\.(.+)", key)
    if m:
        prefix += f"{'enc' if m.group(1) == 'encoder' else 'dec'}{m.group(2)}."
        for pattern, template, fn in _STAGE_RULES:
            mm = re.fullmatch(pattern, m.group(3))
            if mm is None:
                continue
            path = _fill(template, mm.groups())
            collection = "params"
            if path.startswith("buffers:"):
                collection, path = "buffers", path[len("buffers:") :]
            return collection, tuple((prefix + path).split(".")), fn
    raise KeyError(f"no Flax counterpart for state-dict key {key!r}")


def _flax_renames(model: nn.Module) -> dict[str, str]:
    """Module path -> Flax module path, for the modules whose Flax names differ from the port's (see the module)."""
    from ..layers.basic import MLP
    from ..models.factorizer import FactorizerStage
    from ..models.deconver import DeconverStage
    from ..models.unet import UNet

    renames: dict[str, str] = {}
    if isinstance(model, UNet):
        p = model.flax_prefix
        renames["stem"] = p + "stem"
        for i in range(len(model.encoder.blocks)):
            renames[f"encoder.blocks.{i}.downsample"] = f"{p}down{i}"
            renames[f"encoder.blocks.{i}.block"] = f"{p}enc{i}"
        for i in range(len(model.decoder.blocks)):
            renames[f"decoder.blocks.{i}.upsample"] = f"{p}up{i}"
            renames[f"decoder.blocks.{i}.block"] = f"{p}dec{i}"
        renames.update({name: p + name for name in model.head_names()})
    for mpath, module in model.named_modules():  # parents before children, so each rename builds on its parent's
        here = ".".join(_rename(mpath, renames))
        sub = {"fc1": "block.0", "fc2": "block.3"} if isinstance(module, MLP) else {}
        if isinstance(module, (FactorizerStage, DeconverStage)):
            sub = {"adapter_": "adapter"}
        for flax_name, port_name in sub.items():
            renames[f"{mpath}.{port_name}" if mpath else port_name] = f"{here}.{flax_name}" if here else flax_name
    return renames


def _rename(mpath: str, renames: Mapping[str, str]) -> tuple[str, ...]:
    """The Flax path of the module at ``mpath``: its longest renamed prefix, renamed, and the rest as it is."""
    parts = mpath.split(".") if mpath else []
    for n in range(len(parts), 0, -1):
        head = ".".join(parts[:n])
        if head in renames:
            return tuple(p for p in renames[head].split(".") if p) + tuple(parts[n:])
    return tuple(parts)


def _flax_named_paths(model: nn.Module) -> dict[str, tuple[str, tuple[str, ...], Transform]]:
    """State-dict key -> ``(collection, path, transform)`` by module path, class and :func:`_flax_renames`."""
    from ..layers.basic import Conv, ConvTranspose, Dense, _Affine

    renames = _flax_renames(model)
    paths = {}
    for mpath, module in model.named_modules():
        prefix = _rename(mpath, renames)
        for name, param in module.named_parameters(recurse=False):
            shape = tuple(param.shape)
            fn: Transform = None
            if isinstance(module, (Conv, ConvTranspose)):
                leaf = ("conv", "kernel" if name == "weight" else "bias")
                if name == "weight":
                    fn = _conv_weight if isinstance(module, Conv) else _tconv_weight
            elif isinstance(module, (Dense, nn.Linear)):
                if name == "weight":  # a DenseGeneral kernel (in, heads, hd) or (heads, hd, out) folds to (in, out)
                    leaf, fn = ("kernel",), lambda k, s=shape: k.reshape(s[1], s[0]).T
                else:
                    leaf, fn = ("bias",), lambda b, s=shape: b.reshape(s)
            elif isinstance(module, (nn.LayerNorm, nn.GroupNorm, _Affine)):
                leaf = ("scale" if name == "weight" else "bias",)
            else:
                leaf = (name,)
            paths[f"{mpath}.{name}" if mpath else name] = ("params", prefix + leaf, fn)
    return paths


def flax_leaf_paths(model: nn.Module) -> dict[str, tuple[str, tuple[str, ...], Transform]]:
    """State-dict key -> ``(collection, path, transform)`` for every entry of ``model.state_dict()``."""
    from ..models.unet import UNet

    named = _flax_named_paths(model)
    prefix = model.flax_prefix if isinstance(model, UNet) else None
    rules = {}
    for key in model.state_dict():
        rule = None
        if prefix is not None:
            with contextlib.suppress(KeyError):
                rule = flax_path(key, prefix)
        rule = rule or named.get(key)
        if rule is None:
            raise KeyError(f"no Flax counterpart for state-dict key {key!r}")
        rules[key] = rule
    return rules


# The layouts above, undone on a shape: the port's shape -> the Flax leaf's.
_FLAX_SHAPES: dict[Callable, Callable[[tuple], tuple]] = {
    _conv_weight: lambda s: (*s[2:], s[1], s[0]),
    _tconv_weight: lambda s: (*s[2:], s[0], s[1]),
    _linear_weight: lambda s: s[::-1],
    _pos_embed: lambda s: (s[0], *s[2:], s[1]),
}


def flax_leaf_shapes(model: nn.Module) -> dict[str, tuple[int, ...]]:
    """Parameter name -> the shape of the JAX package's leaf behind it: the layouts of the module docstring undone, and
    an attention's ``DenseGeneral`` unfolded (query / key / value kernels ``(in, heads, head_dim)`` and biases
    ``(heads, head_dim)``, the output kernel ``(heads, head_dim, out)``), as Flax's ``MultiHeadDotProductAttention``
    holds them.  No Flax variables are needed.
    """
    from ..layers.basic import Dense
    from ..models.unetr import MultiHeadAttention

    materialize(model)
    modules = dict(model.named_modules())
    heads = {f"{path}.{name}": (name, m.num_heads) for path, m in modules.items() if isinstance(m, MultiHeadAttention)
             for name in ("query", "key", "value", "out")}
    rules = flax_leaf_paths(model)
    out = {}
    for key, param in model.named_parameters():
        shape = tuple(param.shape)
        mpath, _, name = key.rpartition(".")
        fn = rules[key][2]
        if mpath in heads:
            role, h = heads[mpath]
            if role == "out":
                shape = (h, shape[1] // h, shape[0]) if name == "weight" else shape
            else:
                shape = (shape[1], h, shape[0] // h) if name == "weight" else (h, shape[0] // h)
        elif fn in _FLAX_SHAPES:
            shape = _FLAX_SHAPES[fn](shape)
        elif isinstance(modules.get(mpath), (Dense, nn.Linear)) and name == "weight":
            shape = shape[::-1]
        out[key] = shape
    return out


def _leaf_paths(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()) -> set[tuple[str, ...]]:
    out = set()
    for k, v in tree.items():
        out |= _leaf_paths(v, (*prefix, k)) if isinstance(v, Mapping) else {(*prefix, k)}
    return out


def _get(tree: Mapping[str, Any], path: tuple[str, ...]) -> np.ndarray:
    node: Any = tree
    for p in path:
        node = node[p]
    return np.asarray(node)


def flax_state_dict(model: nn.Module, variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of ``model`` that the JAX package's ``{"params", "buffers"}`` variables give, as host
    tensors in the model's dtypes; ``model`` itself is not changed.

    Every entry of ``model.state_dict()`` must have a counterpart; shapes are checked.  Every Flax parameter must be
    used too, except in a Factorizer or a Deconver, whose variables may hold a table that the port computes instead
    (a sinusoidal embedding built where the variables have a learnt one).  A model that takes its rank from its input
    must be built.
    """
    from ..models.unet import UNet

    materialize(model)
    prefix = model.flax_prefix if isinstance(model, UNet) else None
    rules = flax_leaf_paths(model)
    new_state, used = {}, set()
    for key, current in model.state_dict().items():
        collection, path, fn = rules[key]
        used.add(path)
        value = _get(variables[collection], path)
        if fn is not None:
            value = fn(value)
        if tuple(value.shape) != tuple(current.shape):
            raise ValueError(f"{key}: Flax leaf {'.'.join(path)} has shape {value.shape}, expected {tuple(current.shape)}")
        new_state[key] = torch.tensor(np.ascontiguousarray(value)).to(current.dtype)
    unused = sorted(".".join(p) for p in _leaf_paths(variables["params"]) - used)
    if unused and prefix != "unet.":
        raise ValueError(f"Flax parameters without a counterpart in {type(model).__name__}: {unused[:5]}")
    return new_state


def load_flax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Load the JAX package's ``{"params", "buffers"}`` variables into ``model`` in place (:func:`flax_state_dict`)."""
    model.load_state_dict(flax_state_dict(model, variables), strict=True)
    return model
