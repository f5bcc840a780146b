"""Declarative YAML config system with reference / expression / instantiate / overlay semantics.

PyTorch counterpart of ``factorizer_tpu/config/parser.py``: the same verbs on
the same, unedited bundle files (``zoo/<bundle>/configs/*.yaml``), resolved
in this package:

* ``@id`` references another (resolved) config item; ``#`` walks sub-keys
  (``@solver#lr``) and list indices.
* ``$expr`` is a python expression, evaluated with the ``@id`` references in
  it substituted.  The names the bundles write resolve here: ``ftx`` is this
  package (``$ftx.LayerNorm``); ``jnp`` holds the three float dtypes as torch
  dtypes (``$jnp.bfloat16 if @amp else None``); ``jax`` holds
  ``process_count()`` and ``process_index()`` on ``torch.distributed``.
* ``{_target_: Name, ...}`` instantiates a class or callable from the registry
  or a dotted import path; a path under ``factorizer_tpu.`` is read under
  ``factorizer_tpu_torch.``; ``_args_`` are positional, ``_disabled_: true``
  skips.  A module the config builds (``network_def``) goes to the card unless
  its spec names a ``device``.
* overlays: later files and ``key#sub=value`` pairs deep-merge over earlier ones.

Nothing of JAX is imported, also not through a ``_target_``: a path under
``jax``, ``flax``, ``optax`` or ``orbax`` raises.
"""

from __future__ import annotations

import importlib
import inspect
import re
import types
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

import torch
import yaml

__all__ = ["ConfigParser", "load_config_files", "merge_config", "parse_override"]

_REF = re.compile(r"@([A-Za-z_][\w#]*)")
_JAX_PACKAGE, _PORT_PACKAGE = "factorizer_tpu.", "factorizer_tpu_torch."
_JAX_ROOTS = ("jax", "flax", "optax", "orbax", "factorizer_tpu")


def _default_registry() -> dict[str, Any]:
    """Component name -> class or function: the package's public API, ``data.transforms``, ``data.dataset``, ``train``."""
    import factorizer_tpu_torch as ftt
    from factorizer_tpu_torch import train as _train
    from factorizer_tpu_torch.data import dataset as _ds
    from factorizer_tpu_torch.data import transforms as _tf

    reg: dict[str, Any] = {}
    for mod in (_tf, _ds, _train, ftt):
        for name in dir(mod):
            if not name.startswith("_"):
                obj = getattr(mod, name)
                if callable(obj):
                    reg.setdefault(name, obj)
    return reg


class _Namespace(types.SimpleNamespace):
    """A JAX module's name in a bundle's expressions, holding the port's counterparts of the attributes the bundles read."""

    def __getattr__(self, attr: str) -> Any:  # only reached for attributes the namespace lacks
        raise AttributeError(f"{self._name}.{attr} has no counterpart in factorizer_tpu_torch's config expressions")


def _jnp() -> _Namespace:
    return _Namespace(_name="jnp", bfloat16=torch.bfloat16, float16=torch.float16, float32=torch.float32)


def _jax() -> _Namespace:
    from ..parallel.mesh import process_count, process_index

    return _Namespace(_name="jax", process_count=process_count, process_index=process_index)


def _eval_globals() -> dict[str, Any]:
    import glob as _glob
    import math
    import os

    import numpy as np

    import factorizer_tpu_torch as ftt

    return {
        "np": np,
        "numpy": np,
        "jnp": _jnp(),
        "jax": _jax(),
        "math": math,
        "os": os,
        "glob": _glob,
        "ftx": ftt,
        "sorted": sorted,
        "len": len,
        "range": range,
        "list": list,
        "dict": dict,
        "str": str,
        "int": int,
        "float": float,
        "bool": bool,
        "min": min,
        "max": max,
    }


def merge_config(base: dict, overlay: Mapping) -> dict:
    """Deep-merge ``overlay`` into ``base`` (dicts merge, other values replace)."""
    out = dict(base)
    for k, v in overlay.items():
        if "#" in k:
            top, rest = k.split("#", 1)
            sub = dict(out.get(top, {})) if isinstance(out.get(top), Mapping) else {}
            out[top] = merge_config(sub, {rest: v})
        elif isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
            out[k] = merge_config(dict(out[k]), v)
        else:
            out[k] = v
    return out


def parse_override(pair: str) -> tuple[str, Any]:
    """Parse a ``key=value`` CLI override (value via YAML)."""
    key, _, raw = pair.partition("=")
    return key.strip(), yaml.safe_load(raw)


def load_config_files(paths: Sequence[str | Path]) -> dict:
    """The files' configs merged in order, each later one over the ones before."""
    config: dict = {}
    for p in paths:
        with open(p) as f:
            overlay = yaml.safe_load(f) or {}
        config = merge_config(config, overlay)
    return config


def _builds_module(fn: Any) -> bool:
    """Whether ``fn`` is a ``torch.nn.Module`` class whose constructor takes ``device``."""
    if not (isinstance(fn, type) and issubclass(fn, torch.nn.Module)):
        return False
    return "device" in inspect.signature(fn).parameters


class ConfigParser:
    """Lazily resolves a bundle-style config tree into live objects.

    After :meth:`seed`, every object it builds that has ``set_random_state``
    (the bundles' transform chains) is seeded with that seed as it is built.
    """

    def __init__(
        self,
        config: Mapping[str, Any],
        registry: Optional[Mapping[str, Any]] = None,
        globals_: Optional[Mapping[str, Any]] = None,
    ) -> None:
        self.config = dict(config)
        self.registry = dict(registry) if registry is not None else _default_registry()
        # ``$`` expressions see the registry's names too, so helpers such as
        # ``$partition_datalist(...)`` (train_multidevice.yaml) resolve without module paths; the
        # evaluation names win on a collision.
        self.globals = {**self.registry, **_eval_globals()}
        if globals_:
            self.globals.update(globals_)
        self._cache: dict[str, Any] = {}
        self._resolving: set[str] = set()
        self._seed: Optional[int] = None

    def seed(self, seed: int) -> None:
        """Seed what resolving the config draws from: torch's default generator, from which the models draw their
        weights as they are built, now; and each object built from here on that has ``set_random_state``."""
        self._seed = int(seed)
        torch.manual_seed(self._seed)

    # -- raw navigation

    def _get_raw(self, path: str) -> Any:
        node: Any = self.config
        for part in path.split("#"):
            if isinstance(node, Mapping):
                node = node[part]
            elif isinstance(node, (list, tuple)):
                node = node[int(part)]
            else:
                raise KeyError(path)
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self._get_raw(path)
            return True
        except (KeyError, IndexError, ValueError):
            return False

    # -- resolution

    def resolve(self, path: str) -> Any:
        if path in self._cache:
            return self._cache[path]
        if path in self._resolving:
            raise ValueError(f"Circular config reference at {path!r}.")
        self._resolving.add(path)
        try:
            value = self._resolve_value(self._get_raw(path))
        finally:
            self._resolving.discard(path)
        self._cache[path] = value
        return value

    __getitem__ = resolve

    def get(self, path: str, default: Any = None) -> Any:
        try:
            return self.resolve(path)
        except (KeyError, IndexError):
            return default

    def _resolve_value(self, v: Any) -> Any:
        if isinstance(v, Mapping):
            if v.get("_disabled_"):
                return None
            if "_target_" in v:
                return self._instantiate(v)
            return {k: self._resolve_value(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [self._resolve_value(x) for x in v]
        if isinstance(v, str):
            if v.startswith("@"):
                return self.resolve(v[1:])
            if v.startswith("$"):
                return self._evaluate(v[1:])
            return v
        return v

    def _instantiate(self, spec: Mapping[str, Any]) -> Any:
        fn = self._lookup(spec["_target_"])
        args = [self._resolve_value(a) for a in spec.get("_args_", [])]
        kwargs = {
            k: self._resolve_value(v)
            for k, v in spec.items()
            if k not in ("_target_", "_args_", "_disabled_")
        }
        if kwargs.get("device") is None and _builds_module(fn):
            from ..utils.helpers import resolve_device

            kwargs["device"] = resolve_device(None)
        obj = fn(*args, **kwargs)
        if self._seed is not None and hasattr(obj, "set_random_state"):
            obj.set_random_state(self._seed)
        return obj

    def _lookup(self, target: str) -> Any:
        if target in self.registry:
            return self.registry[target]
        if "." not in target:
            raise KeyError(f"Unknown _target_ {target!r}: factorizer_tpu_torch has no component of that name")
        path = _PORT_PACKAGE + target[len(_JAX_PACKAGE):] if target.startswith(_JAX_PACKAGE) else target
        if path.split(".", 1)[0] in _JAX_ROOTS:
            raise KeyError(f"_target_ {target!r} is JAX's; factorizer_tpu_torch does not import it")
        mod_name, _, attr = path.rpartition(".")
        mod = importlib.import_module(mod_name)
        if not hasattr(mod, attr):
            raise AttributeError(f"_target_ {target!r}: {mod_name} has no {attr!r} in factorizer_tpu_torch")
        return getattr(mod, attr)

    def _evaluate(self, expr: str) -> Any:
        env: dict[str, Any] = {}

        def sub(m: re.Match) -> str:
            name = f"__ref_{len(env)}"
            env[name] = self.resolve(m.group(1))
            return name

        py = _REF.sub(sub, expr)
        return eval(py, dict(self.globals), env)  # noqa: S307 — bundle exprs are trusted config
