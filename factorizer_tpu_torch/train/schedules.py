"""Optimiser and learning-rate schedule factories.

PyTorch counterpart of ``factorizer_tpu/train/schedules.py``: the bundles'
AdamW with a warm-up-cosine schedule.  The schedule is a pure function
``step -> lr`` that reproduces ``optax.warmup_cosine_decay_schedule`` value
for value; the trainer writes it into the optimiser's ``lr`` before each
update, counting updates from 0 as optax does, so the first update runs at
lr 0.  optax's AdamW multiplies the weight decay by the learning rate, as
``torch.optim.AdamW`` does, so the two take the same ``weight_decay``.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

__all__ = ["warmup_cosine_schedule", "make_adamw", "sum_of_squares", "global_norm", "clip_by_global_norm"]

Schedule = Callable[[int], float]


def warmup_cosine_schedule(lr: float, warmup_steps: int, total_steps: int, end_lr: float = 0.0) -> Schedule:
    """Linear warm-up from 0 to ``lr`` over ``warmup_steps``, then cosine decay to ``end_lr`` at ``total_steps``."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup
    if decay <= 0:
        raise ValueError(f"total_steps {total_steps} leaves no step after a warm-up of {warmup}")
    alpha = 0.0 if lr == 0.0 else end_lr / lr

    def schedule(step: int) -> float:
        if step < warmup:
            return lr * max(step, 0) / warmup
        t = min(step - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_adamw(
    params: Iterable[torch.nn.Parameter],
    lr: float = 1e-3,
    weight_decay: float = 1e-2,
    warmup_steps: Optional[int] = None,
    total_steps: Optional[int] = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[torch.optim.AdamW, Optional[Schedule]]:
    """AdamW over ``params`` (fused on the card) and its schedule, or None for a constant ``lr``.

    Gradient clipping is not part of the optimiser here: the trainer applies
    :func:`clip_by_global_norm` before the update.
    """
    params = list(params)
    schedule = None
    if warmup_steps is not None and total_steps is not None:
        schedule = warmup_cosine_schedule(lr, warmup_steps, total_steps)
    fused = bool(params) and all(p.is_cuda for p in params)
    opt = torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay, fused=fused)
    return opt, schedule


def sum_of_squares(grads: Iterable[torch.Tensor]):
    """The sum of the squares of all ``grads``' elements, in float32 (float64 gradients in float64, as optax keeps
    a leaf's dtype); 0 for no gradient."""
    return sum(g.detach().to(torch.promote_types(g.dtype, torch.float32)).pow(2).sum() for g in grads)


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """The l2 norm of all ``grads`` taken as one vector (``optax.global_norm``)."""
    return torch.sqrt(sum_of_squares(grads))


def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``; returns the norm before.

    Reproduces ``optax.clip_by_global_norm``: below ``max_norm`` the gradients
    stay as they are, else each becomes ``g / norm * max_norm`` (no epsilon in
    the denominator, unlike ``torch.nn.utils.clip_grad_norm_``).  ``norm``: the
    global norm where ``grads`` are parts of the gradient (a sharded state's),
    computed over every process by the caller.
    """
    grads = list(grads)
    norm = global_norm(grads) if norm is None else norm
    if not bool(norm < max_norm):
        for g in grads:
            g.copy_(g / norm.to(g.dtype) * max_norm)
    return norm
