"""Helpers shared across the port: tuple broadcasting and the default device.

``to_ntuple`` is the counterpart of the helper in
``factorizer_tpu/utils/helpers.py``.  ``resolve_device`` has none there (JAX
places arrays on its default backend): it is the one place where the port's
entry points turn ``device=None`` into the card.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import torch

__all__ = ["to_ntuple", "resolve_device"]


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
