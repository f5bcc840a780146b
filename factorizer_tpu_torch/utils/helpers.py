"""Helpers shared across the port: tuples, the ``partialize`` idiom, the default device, late-built models.

``Universaltuple``, ``as_tuple``, ``to_ntuple``, ``cumprod``, ``has_args``,
``partialize`` and ``is_partializable`` are the counterparts of the helpers in
``factorizer_tpu/utils/helpers.py``, ``spec_accepts`` of the one in
``factorizer_tpu/models/unet.py``.  ``build_spec`` builds a spec with the
entries of a context (device, generator) that its class takes, which a Flax
module never needs.
``resolve_device`` has none there (JAX places arrays on its default backend):
it is the one place where the port's entry points turn ``device=None`` into
the card.  ``materialize`` has none either: a Flax module takes its rank from
the input it is initialised with, and the port's ``SegResNet`` builds its
layers at its first input, or when an entry point that knows ``roi_size``
calls ``materialize``.
"""

from __future__ import annotations

import dataclasses
import inspect
from collections.abc import Mapping, Sequence
from functools import partial
from itertools import accumulate
from operator import mul
from typing import Any, Callable, Iterable, Optional

import torch

__all__ = [
    "Universaltuple", "as_tuple", "to_ntuple", "cumprod", "has_args", "partialize", "is_partializable", "spec_accepts",
    "build_spec", "resolve_device", "materialize",
]


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds or runs on: ``None`` means the card.

    Entry points never carry on on the CPU by default: without a CUDA device
    ``None`` raises, and the CPU is used only when the caller names it
    (``device="cpu"``), as the tests do.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class Universaltuple(tuple):
    """A tuple whose membership test always succeeds.

    Useful as a sentinel for "applies to every index" in per-stage configs.
    """

    def __contains__(self, other: Any) -> bool:  # noqa: D105
        return True


def to_ntuple(obj: Any, n: int) -> tuple[Any, ...]:
    """Broadcast a scalar to an ``n``-tuple, or validate a length-``n`` sequence."""
    if not isinstance(obj, Sequence) or isinstance(obj, str):
        return (obj,) * n
    t = tuple(obj)
    if len(t) == 1:
        return t * n
    if len(t) != n:
        raise ValueError(f"Expected length-{n} sequence, got {t!r}.")
    return t


def as_tuple(obj: Any) -> tuple[Any, ...]:
    """Convert ``obj`` to a tuple; strings and scalars become 1-tuples."""
    if not isinstance(obj, Sequence) or isinstance(obj, str):
        return (obj,)
    return tuple(obj)


def cumprod(x: Iterable[float]) -> list[float]:
    """Cumulative product of an iterable."""
    return list(accumulate(x, mul))


def has_args(obj: Any, keywords: str | Sequence[str]) -> bool:
    """True if callable ``obj`` accepts all of the given keyword arguments."""
    if not callable(obj):
        return False
    try:
        sig = inspect.signature(obj)
    except (ValueError, TypeError):
        return False
    return all(key in sig.parameters for key in as_tuple(keywords))


def partialize(obj: Any) -> Callable:
    """Resolve ``Callable | (Callable, args..., kwargs...)`` into a callable.

    Tuple elements after the callable may be dicts (merged as keyword args) or
    sequences (extended as positional args); any other value is appended as a
    single positional arg.
    """
    if callable(obj):
        return obj
    if isinstance(obj, Sequence) and obj and callable(obj[0]):
        args: list[Any] = []
        kwargs: dict[str, Any] = {}
        for item in obj[1:]:
            if isinstance(item, Mapping):
                kwargs.update(item)
            elif isinstance(item, Sequence) and not isinstance(item, str):
                args.extend(item)
            else:
                args.append(item)
        return partial(obj[0], *args, **kwargs)
    raise TypeError(f"Expected a callable or (callable, args...) tuple, got {type(obj).__name__}")


def is_partializable(obj: Any) -> bool:
    """True if ``partialize(obj)`` would succeed."""
    if callable(obj):
        return True
    return bool(isinstance(obj, Sequence) and obj and callable(obj[0]))


def spec_accepts(spec: Any, key: str) -> bool:
    """True if the class or callable under the partializable ``spec`` accepts keyword ``key``."""
    fn = partialize(spec)
    cls = getattr(fn, "func", fn)
    if isinstance(cls, type) and dataclasses.is_dataclass(cls):
        return any(f.name == key for f in dataclasses.fields(cls))
    try:
        return key in inspect.signature(cls).parameters
    except (TypeError, ValueError):
        return False


def build_spec(spec: Any, *args, context: Mapping[str, Any], **kwargs) -> Any:
    """``partialize(spec)(*args, **kwargs)`` with the entries of ``context`` (device, generator, ...) that its class
    takes."""
    fn = partialize(spec)
    cls = getattr(fn, "func", fn)
    return fn(*args, **kwargs, **{k: v for k, v in context.items() if has_args(cls, k)})


def materialize(model: torch.nn.Module, spatial_dims: Optional[int] = None) -> torch.nn.Module:
    """Build the layers of a model that takes its rank from its input (``SegResNet``) at ``spatial_dims``.

    Entry points call it with ``len(roi_size)`` before they move the model,
    make its optimiser or load weights into it.  A model built already is
    returned as it is; ``spatial_dims=None`` only checks that it is built.
    """
    build = getattr(model, "materialize", None)
    if build is None or model.materialized:
        return model
    if spatial_dims is None:
        raise RuntimeError(f"{type(model).__name__} takes its rank from its input and has not been built yet: "
                           "call materialize(spatial_dims) or run a forward first")
    return build(spatial_dims)
