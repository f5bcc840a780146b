"""Training-loop core: the train state and the step functions.

PyTorch counterpart of ``factorizer_tpu/train/trainer.py``.  The JAX step is
a pure function over an immutable state; here the state is a small object
holding the model, the optimiser, the schedule and the step count, and the
step updates it in place and hands it back, so callers read the same
``state, metrics = step(state, batch)``.

With ``mesh=`` the step is data parallel: every process of the mesh holds
the model and the whole batch, steps on its shard of the batch
(``parallel.shard_batch``), and the gradients are averaged over ``data_axis``
during the backward (``parallel.data_parallel``), so that all processes make
the same update; the metrics are the whole batch's.

Not ported: the flat raveled optimiser (a workaround for the TPU's per-op
cost; AdamW is fused on the card instead), buffer donation, and the
``spatial_axis`` argument (a whole model on slabs of the volume needs halos
for its convolutions too; ``make_train_step`` does not take the name).
bf16 is the model's own ``dtype=torch.bfloat16`` (f32 parameters, bf16
activations, f32 loss), so there is no gradient scaler.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch
import torch.distributed as dist
from torch import nn

from ..parallel.collectives import all_gather_cat
from ..parallel.mesh import Mesh
from ..parallel.sharding import data_parallel, shard_batch
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


def make_train_step(model: nn.Module, loss_fn: Optional[Callable] = None, accum_steps: int = 1,
                    mesh: Optional[Mesh] = None, data_axis: str = "data"):
    """Build ``(state, batch) -> (state, {"loss", "grad_norm"})`` for ``model``.

    ``batch`` holds ``"image"`` and ``"label"``, both ``(B, C, *S)``, on the
    model's device.  ``accum_steps > 1`` splits the batch into that many
    micro-batches and sums their gradients, scaled by ``1 / accum_steps``,
    before the single update: with mean-reduced losses that is the full-batch
    gradient at one micro-batch's activation memory.  The gradients of the
    step stay in ``p.grad`` until the next step clears them.

    With ``mesh`` every process calls the step with the same whole batch and
    runs its shard over ``data_axis`` (equal shards, or the call raises); the
    gradients left in ``p.grad``, ``loss`` and ``grad_norm`` are those of the
    whole batch, on every process alike.  Building the step is collective (the
    first process's parameters go to the others) and hooks the gradient
    exchange onto ``model``'s parameters: build one step per model.
    """
    loss_fn = loss_fn or _default_loss
    net = model if mesh is None else data_parallel(model, mesh, data_axis)

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if mesh is not None:
            batch = shard_batch(batch, mesh, data_axis)
        images, labels = batch["image"], batch["label"]
        b = images.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
        net.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = 0.0
        micros = list(zip(images.chunk(accum_steps), labels.chunk(accum_steps)))
        for i, (im, lb) in enumerate(micros):
            # The gradients cross the processes once, with the last micro-batch's backward.
            held = net.no_sync() if mesh is not None and i < len(micros) - 1 else contextlib.nullcontext()
            with held:
                micro = loss_fn(net(im), lb) / accum_steps
                micro.backward()
            loss = loss + micro.detach()
        if mesh is not None:  # equal shards: the mean of their mean losses is the batch's
            dist.all_reduce(loss, group=mesh.group(data_axis))
            loss = loss / mesh.axis_size(data_axis)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if state.grad_clip_norm is not None:
            grad_norm = clip_by_global_norm(grads, state.grad_clip_norm)
        else:
            grad_norm = global_norm(grads)
        state.apply_gradients()
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step


def make_eval_step(model: nn.Module, mesh: Optional[Mesh] = None, data_axis: str = "data"):
    """Build ``images -> logits`` in inference mode (no dropout, no graph).

    With ``mesh`` every process passes the whole batch and gets the whole
    batch's logits back: where the batch splits evenly over ``data_axis``,
    each process runs its shard and the shards' logits are gathered; where it
    does not (or the mesh lacks the axis), every process runs the whole batch
    itself, so any batch size is taken, as the single-process step takes it.
    """

    @torch.no_grad()
    def step(images: torch.Tensor):
        model.eval()
        if mesh is None or data_axis not in mesh.shape or images.shape[0] % mesh.axis_size(data_axis):
            return model(images)
        return all_gather_cat(model(shard_batch(images, mesh, data_axis)), mesh, data_axis)

    return step
