"""Training-loop core: the train state and the step functions.

PyTorch counterpart of ``factorizer_tpu/train/trainer.py``.  The JAX step is
a pure function over an immutable state; here the state is a small object
holding the model, the optimiser, the schedule and the step count, and the
step updates it in place and hands it back, so callers read the same
``state, metrics = step(state, batch)``.

Not ported: the flat raveled optimiser (a workaround for the TPU's per-op
cost; AdamW is fused on the card instead), the mesh / spatial-axis sharding
arguments and buffer donation.  bf16 is the model's own
``dtype=torch.bfloat16`` (f32 parameters, bf16 activations, f32 loss), so
there is no gradient scaler.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch
from torch import nn

from ..utils.helpers import resolve_device
from .losses import deep_supervision_loss, dice_ce_loss
from .schedules import Schedule, clip_by_global_norm, global_norm, make_adamw

__all__ = ["TrainState", "create_train_state", "make_train_step", "make_eval_step"]


@dataclass
class TrainState:
    """Model, optimiser, schedule (None = the optimiser's constant lr) and the count of updates made."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Optional[Schedule] = None
    grad_clip_norm: Optional[float] = None
    step: int = 0

    def apply_gradients(self) -> "TrainState":
        """One optimiser update from the gradients held in ``p.grad``, at ``schedule(step)``."""
        if self.schedule is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        return self


def create_train_state(
    model: Union[nn.Module, Callable[..., nn.Module]],
    device=None,
    grad_clip_norm: Optional[float] = None,
    **optimizer_settings,
) -> TrainState:
    """A train state on ``device`` (None = the card; ``"cpu"`` only when asked for).

    ``model`` is a module, which is moved there, or a factory taking
    ``device=``.  ``optimizer_settings`` go to :func:`make_adamw` (``lr``,
    ``weight_decay``, ``warmup_steps``, ``total_steps``, ``b1``, ``b2``, ``eps``).
    """
    device = resolve_device(device)
    model = model.to(device) if isinstance(model, nn.Module) else model(device=device)
    optimizer, schedule = make_adamw(model.parameters(), **optimizer_settings)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule, grad_clip_norm=grad_clip_norm)


def _default_loss(logits, labels) -> torch.Tensor:
    if isinstance(logits, (list, tuple)):
        return deep_supervision_loss(logits, labels)
    return dice_ce_loss(logits, labels)


def make_train_step(model: nn.Module, loss_fn: Optional[Callable] = None, accum_steps: int = 1):
    """Build ``(state, batch) -> (state, {"loss", "grad_norm"})`` for ``model``.

    ``batch`` holds ``"image"`` and ``"label"``, both ``(B, C, *S)``, on the
    model's device.  ``accum_steps > 1`` splits the batch into that many
    micro-batches and sums their gradients, scaled by ``1 / accum_steps``,
    before the single update: with mean-reduced losses that is the full-batch
    gradient at one micro-batch's activation memory.  The gradients of the
    step stay in ``p.grad`` until the next step clears them.
    """
    loss_fn = loss_fn or _default_loss

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        images, labels = batch["image"], batch["label"]
        b = images.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = 0.0
        for im, lb in zip(images.chunk(accum_steps), labels.chunk(accum_steps)):
            micro = loss_fn(model(im), lb) / accum_steps
            micro.backward()
            loss = loss + micro.detach()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if state.grad_clip_norm is not None:
            grad_norm = clip_by_global_norm(grads, state.grad_clip_norm)
        else:
            grad_norm = global_norm(grads)
        state.apply_gradients()
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step


def make_eval_step(model: nn.Module):
    """Build ``images -> logits`` in inference mode (no dropout, no graph)."""

    @torch.no_grad()
    def step(images: torch.Tensor):
        model.eval()
        return model(images)

    return step
