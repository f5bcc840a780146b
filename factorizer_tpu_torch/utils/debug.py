"""Debugging helpers: NaN trapping and finiteness checks of tensors and state dicts.

PyTorch counterpart of ``factorizer_tpu/utils/debug.py``.  :func:`debug_nans`
makes the first operation that produces a NaN raise, in the forward (a check
of every module's output) and in the backward (autograd's anomaly mode with its
NaN check); :func:`assert_finite` validates a tensor, a sequence or a mapping
of them (a ``state_dict``, gradients), and :func:`tree_norms` gives each
entry's L2 norm for logging.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping, Sequence
from typing import Any, Iterator

import torch
from torch import nn

__all__ = ["debug_nans", "assert_finite", "tree_norms"]


def _check_output(module: nn.Module, args: Any, output: Any) -> None:
    for name, t in _leaves(output, type(module).__name__):
        if t.is_floating_point() and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"NaN in the output of {name}")


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Context manager: raise ``FloatingPointError`` at the first module whose forward output holds a NaN, and
    ``RuntimeError`` at the first backward function that returns one (``torch.autograd.set_detect_anomaly`` with
    ``check_nan``).  The previous anomaly setting is restored on exit; ``enable=False`` turns both off inside."""
    previous = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(enable, check_nan=enable)
    handle = nn.modules.module.register_module_forward_hook(_check_output) if enable else None
    try:
        yield
    finally:
        if handle is not None:
            handle.remove()
        torch.autograd.set_detect_anomaly(*previous)


def _leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """``(name, tensor)`` for every tensor of ``tree``: a tensor, a mapping or a sequence of them, nested."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, Sequence) and not isinstance(tree, str):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")


def assert_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first five entries of ``tree`` (a tensor, or a mapping or sequence of
    them, such as a ``state_dict`` or gradients) that hold a non-finite value."""
    bad = [key for key, t in _leaves(tree) if not bool(torch.isfinite(t).all())]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:5]}")


def tree_norms(tree: Any) -> dict[str, float]:
    """Entry name -> L2 norm of the entry, in its own floating dtype, at least float32 (for logging gradient and
    parameter health)."""
    return {key: float(torch.linalg.vector_norm(t.detach().to(torch.promote_types(t.dtype, torch.float32))))
            for key, t in _leaves(tree)}
