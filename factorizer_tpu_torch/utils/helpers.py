"""Tuple helper shared by the layers and reshapes.

PyTorch counterpart of the one helper of ``factorizer_tpu/utils/helpers.py``
that the serving slice needs.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any

__all__ = ["to_ntuple"]


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
