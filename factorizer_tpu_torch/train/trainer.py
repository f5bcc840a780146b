"""Training-loop core: the train state and the step functions.

PyTorch counterpart of ``factorizer_tpu/train/trainer.py``.  The JAX step is
a pure function over an immutable state; here the state is a small object
holding the model, the optimiser, the schedule and the step count, and the
step updates it in place and hands it back, so callers read the same
``state, metrics = step(state, batch)``.

With ``mesh=`` the step is data parallel: the gradients are averaged over
``data_axis`` during the backward (``parallel.data_parallel``), so that all
processes make the same update, and the metrics are the global batch's.  The
batch is either the whole global batch on every process, which each cuts to
its shard (``parallel.shard_batch``), or, with ``local_batch=True``, this
process's block of it, as a loader over a partition of the datalist gives it.

With ``spatial_axis=`` as well the step is the whole-model spatial step
(JAX's ``spatial_axis``, which GSPMD partitions): the processes of one
``spatial_axis`` line take one batch, the first process's, and each runs the
model and the loss on its slab of the volume's first spatial axis
(``parallel.slabs``): equal slabs where the process count divides its rows,
else slabs of unequal rows, one cut for the line (``parallel.slabs.choose_cut``),
as GSPMD pads such a cut; with more processes than rows, some slabs hold none
(the whole model then runs gathered).  Gradients are summed over ``spatial_axis``, where
each slab gives a part, and averaged over ``data_axis``.  With ``model_axis=``
instead the processes of a ``model_axis`` line take one batch, the first
process's, and each runs the whole model on it.

Weight sharding (JAX's ``param_sharding_rules`` over the model axis):
``create_train_state(model, mesh=, model_axis=)`` holds each parameter that
JAX's rule cuts as this process's part of it, with its AdamW moments
(``parallel.shard_parameters``).  The step gathers the whole weights before
the forward, and after the backward turns their gradients into the parts'
(a reduce-scatter on slabs, where each slab gives a part of the gradient; a
local cut where every process of the line computed the same one) and frees
them; the other parameters keep the path above.  The gradient norm sums the
parts' squares over the axis, so it and the clipping are the whole step's.
The state's :meth:`TrainState.state_dict` is whole, as a one-process run
saves it.

Not ported: the flat raveled optimiser (a workaround for the TPU's per-op
cost; AdamW is fused on the card instead) and buffer donation.
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

from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..parallel.collectives import all_gather_cat, broadcast_from_first
from ..parallel.mesh import Mesh
from ..parallel.sharding import ShardedParameters, data_parallel, shard_batch, shard_parameters
from ..parallel.slabs import Slabs, on_slabs, require_slab_path, slab_cut, slab_route
from ..utils.helpers import materialize, resolve_device
from ..utils.profiling import span
from .losses import deep_supervision_loss, dice_ce_loss
from .schedules import Schedule, clip_by_global_norm, global_norm, make_adamw, sum_of_squares

__all__ = ["TrainState", "create_train_state", "make_train_step", "make_eval_step", "state_bytes"]


@dataclass
class TrainState:
    """Model, optimiser, schedule (None = the optimiser's constant lr), the count of updates made, and the model-axis
    layout of the parameters (None: every parameter whole on every process)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Optional[Schedule] = None
    grad_clip_norm: Optional[float] = None
    step: int = 0
    shards: Optional[ShardedParameters] = None

    def apply_gradients(self) -> "TrainState":
        """One optimiser update from the gradients held in ``p.grad``, at ``schedule(step)``."""
        if self.schedule is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        return self

    def _moment_index(self) -> dict[int, str]:
        """The optimiser's state index of each shard -> its leaf's name."""
        position = {id(p): i for i, p in enumerate(p for g in self.optimizer.param_groups for p in g["params"])}
        return {position[id(s)]: k for k, s in zip(self.shards.names, self.shards.shards)}

    def state_dict(self) -> dict:
        """``{"step", "model", "optimizer"}``: the model's and AdamW's ``state_dict`` as a one-process run holds them
        (whole leaves, the optimiser's state indexed in the model's parameter order).  Collective where the state is
        sharded: every process calls it."""
        if self.shards is None:
            return {"step": int(self.step), "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}
        sh = self.shards
        with sh.gathered():
            model = self.model.state_dict()  # views of the gathered leaves, which outlive the release
        optimizer = self.optimizer.state_dict()
        index = self._moment_index()
        state = dict(optimizer["state"])
        if any(i in state for i in index):
            for moment in ("exp_avg", "exp_avg_sq"):
                whole = sh.gather_flat(sh.pack([state[i][moment] for i in index]))
                for i, leaf in zip(index, whole):
                    state[i] = {**state[i], moment: leaf}
        return {"step": int(self.step), "model": model, "optimizer": {**optimizer, "state": state}}

    def load_state_dict(self, payload: dict) -> "TrainState":
        """Load a :meth:`state_dict` (whole, as any run saves it); a sharded state keeps its part of each sharded
        leaf and of its moments."""
        self.step = int(payload["step"])
        if self.shards is None:
            self.model.load_state_dict(payload["model"])
            self.optimizer.load_state_dict(payload["optimizer"])
            return self
        sh = self.shards
        model = dict(payload["model"])
        whole = {k: model.pop(k) for k in sh.names}
        missing, unexpected = self.model.load_state_dict(model, strict=False)
        if set(missing) != set(sh.names) or unexpected:
            raise KeyError(f"load_state_dict: missing {sorted(set(missing) - set(sh.names))}, unexpected {unexpected}")
        with torch.no_grad():
            for k, shape, s in zip(sh.names, sh.shapes, sh.shards):
                if tuple(whole[k].shape) != shape:
                    raise ValueError(f"load_state_dict: {k} has shape {tuple(whole[k].shape)}, expected {shape}")
                s.copy_(sh.cut(k, whole[k]))
        optimizer = payload["optimizer"]
        state = dict(optimizer["state"])
        for i, k in self._moment_index().items():
            if i in state:
                # A copy of the part: a view would keep the whole moment alive.
                state[i] = {m: sh.cut(k, v).clone() if m in ("exp_avg", "exp_avg_sq") else v
                            for m, v in state[i].items()}
        self.optimizer.load_state_dict({**optimizer, "state": state})
        return self


def state_bytes(state: TrainState) -> int:
    """The bytes of the parameters and the optimiser's state that this process holds between steps."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    moments = [t for s in state.optimizer.state.values() for t in s.values() if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in params + moments)


def create_train_state(
    model: Union[nn.Module, Callable[..., nn.Module]],
    device=None,
    grad_clip_norm: Optional[float] = None,
    mesh: Optional[Mesh] = None,
    model_axis: Optional[str] = None,
    min_weight_size: int = 2**14,
    **optimizer_settings,
) -> TrainState:
    """A train state on ``device`` (None = the card; ``"cpu"`` only when asked for).

    ``model`` is a module, which is moved there, or a factory taking
    ``device=``; a model that takes its rank from its input must be built
    (``utils.helpers.materialize``).  ``optimizer_settings`` go to :func:`make_adamw` (``lr``,
    ``weight_decay``, ``warmup_steps``, ``total_steps``, ``b1``, ``b2``, ``eps``).

    With ``mesh`` and ``model_axis`` (an axis of it above size 1) the
    parameters that JAX's ``param_sharding_rules(..., min_weight_size)`` cuts
    are held sharded over that axis (``parallel.shard_parameters``,
    collective: every process builds its state), AdamW runs on the parts, and
    the step must run over the same axis (``make_train_step``'s
    ``spatial_axis`` or ``model_axis``).
    """
    device = resolve_device(device)
    model = materialize(model).to(device) if isinstance(model, nn.Module) else materialize(model(device=device))
    shards = None
    if mesh is not None and model_axis is not None and mesh.size > 1:
        shards = shard_parameters(model, mesh, model_axis, min_weight_size)
    params = model.parameters() if shards is None else shards.optimizer_parameters()
    optimizer, schedule = make_adamw(params, **optimizer_settings)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule, grad_clip_norm=grad_clip_norm,
                      shards=shards)


def _default_loss(logits, labels, **kwargs) -> torch.Tensor:
    if isinstance(logits, (list, tuple)):
        return deep_supervision_loss(logits, labels, **kwargs)
    return dice_ce_loss(logits, labels, **kwargs)


def _sum_grads(params: list, mesh: Mesh, axis: str, scale: float = 1.0) -> None:
    """Sum the gradients in ``p.grad`` over ``axis`` (of more than one process) in one flat all-reduce, times ``scale``."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.group(axis))
    if scale != 1.0:
        flat.mul_(scale)
    for g, synced in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(synced)


def _grad_norm(state: TrainState, grads: list) -> torch.Tensor:
    """The global norm of the step's gradient: the parts' squares summed over the model axis, the whole ones once."""
    sh = state.shards
    if sh is None:
        return global_norm(grads)
    parts = sum_of_squares(s.grad for s in sh.shards)
    dist.all_reduce(parts, group=sh.mesh.group(sh.axis))
    return torch.sqrt(sum_of_squares(p.grad for p in sh.replicated() if p.grad is not None) + parts)


def make_train_step(model: nn.Module, loss_fn: Optional[Callable] = None, accum_steps: int = 1,
                    mesh: Optional[Mesh] = None, data_axis: str = "data", spatial_axis: Optional[str] = None,
                    local_batch: bool = False, model_axis: Optional[str] = None):
    """Build ``(state, batch) -> (state, {"loss", "grad_norm"})`` for ``model``.

    ``batch`` holds ``"image"`` and ``"label"``, both ``(B, C, *S)``, on the
    model's device.  ``accum_steps > 1`` splits the batch into that many
    micro-batches and sums their gradients, scaled by ``1 / accum_steps``,
    before the single update: with mean-reduced losses that is the full-batch
    gradient at one micro-batch's activation memory.  The gradients of the
    step stay in ``p.grad`` until the next step clears them (a sharded
    state's in its shards).  Under a profiler the step opens the spans
    ``train.forward`` and ``train.backward`` per micro-batch and
    ``train.update`` once (``utils.profiling.span``).

    With ``mesh`` every process calls the step with the same whole batch and
    runs its shard over ``data_axis`` (equal shards, or the call raises); with
    ``local_batch=True`` each process calls it with its own block of the
    global batch instead, which it runs as it is (blocks of one size on every
    process).  The gradients left in ``p.grad``, ``loss`` and ``grad_norm``
    are those of the global batch, on every process alike.  Building the step
    is collective (the first process's parameters go to the others) and hooks
    the gradient exchange onto ``model``'s parameters: build one step per
    model.  A mesh of one process is the plain step.

    ``spatial_axis`` (with ``mesh``): the spatial step, see the module.  The
    batch that the first process of a ``spatial_axis`` line holds is broadcast
    over the line, then cut over ``data_axis`` (unless ``local_batch``) and
    each process runs its slab.  ``loss_fn`` is called with ``slabs=`` (the
    default, DiceCE or its deep-supervision form, sums over the slabs).  The
    model must have a slab path (``parallel.slabs.require_slab_path``, checked
    here whatever the axis's size): every model the port builds has one (an
    unbuilt SegResNet raises by name); the parts without their own run gathered
    by the model's rule (``parallel.slabs.slab_route``), which the first step
    prints on the first process.

    ``model_axis`` (with ``mesh``, without ``spatial_axis``): the processes of
    a ``model_axis`` line take the first one's batch and each runs the whole
    model on it, as JAX's step runs a batch that is not cut over the model
    axis; their gradients are the same and are not summed over the line.  A
    state whose parameters are sharded (``create_train_state(mesh=,
    model_axis=)``) needs a step over its axis, as ``spatial_axis`` or as
    ``model_axis``.
    """
    loss_fn = loss_fn or _default_loss
    for name, axis in (("spatial_axis", spatial_axis), ("model_axis", model_axis)):
        if axis is not None:
            if mesh is None:
                raise ValueError(f"make_train_step: {name} needs a mesh")
            mesh.axis_size(axis)  # raises on an axis the mesh lacks
    if spatial_axis is not None:
        require_slab_path(model)
    if mesh is not None and mesh.size == 1:
        mesh = spatial_axis = model_axis = None
    spatial = spatial_axis is not None
    line = spatial_axis if spatial else (model_axis if model_axis is not None and mesh.axis_size(model_axis) > 1
                                         else None)
    data_size = 1 if mesh is None or data_axis not in mesh.shape else mesh.axis_size(data_axis)
    if line is not None:
        params = list(model.parameters())
        with torch.no_grad():  # one model on every process, as DistributedDataParallel makes it
            for t in [*params, *model.buffers()]:
                if t.numel():  # a sharded state's leaves hold nothing between steps: its shards came from process 0
                    dist.broadcast(t, src=0)
        net = model
    else:
        net = model if mesh is None or data_size == 1 else data_parallel(model, mesh, data_axis)

    def prepare(batch: dict) -> tuple[dict, Optional[Slabs]]:
        if mesh is None:
            return batch, None
        slabs = None
        if spatial:  # the line's cut, alike on every process and before any collective
            slabs = Slabs(mesh, spatial_axis, slab_cut(model, batch["image"].shape[2], mesh.axis_size(spatial_axis)))
        if line is not None:  # the line's one batch, the first's
            batch = {k: broadcast_from_first(batch[k].contiguous(), mesh, line) for k in ("image", "label")}
        if not local_batch:
            batch = shard_batch(batch, mesh, data_axis)
        if spatial:
            batch = shard_batch(batch, mesh, data_axis=None, spatial_axis=spatial_axis,
                                sizes=slabs.cut.sizes(slabs.cut.rows))
        return batch, slabs

    printed = []

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        sharded = state.shards
        if sharded is not None and sharded.axis != line:
            raise ValueError(f"make_train_step: the state's parameters are sharded over {sharded.axis!r}, but the step "
                             f"runs over {line!r}: build it with spatial_axis= or model_axis={sharded.axis!r}")
        if sharded is not None:  # whole for the step: the route and the forward read the leaves' shapes
            sharded.gather()
        try:
            batch, slabs = prepare(batch)
            images, labels = batch["image"], batch["label"]
            if spatial and not printed:
                printed.append(slab_route(model, slabs.cut))
                if dist.get_rank() == 0:
                    print(f"spatial step: {type(model).__name__} on {slabs.n} slabs of {slabs.cut.describe()} rows: "
                          f"{printed[0]}", flush=True)
            b = images.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
            net.train()
            state.optimizer.zero_grad(set_to_none=True)
            loss = 0.0
            micros = list(zip(images.chunk(accum_steps), labels.chunk(accum_steps)))
            for i, (im, lb) in enumerate(micros):
                if spatial:  # the backward runs on slabs too: a rematerialised stage repeats its forward there
                    held = on_slabs(model, slabs)
                elif net is not model and i < len(micros) - 1:
                    held = net.no_sync()  # the gradients cross the processes once, with the last micro-batch's backward
                else:
                    held = contextlib.nullcontext()
                with held:
                    with span("train.forward"):
                        out = net(im)
                        micro = (loss_fn(out, lb, slabs=slabs) if spatial else loss_fn(out, lb)) / accum_steps
                        loss = loss + micro.detach()
                    with span("train.backward"):
                        micro.backward()
        except BaseException:
            if sharded is not None:
                sharded.release()
            raise
        with span("train.update"):
            if sharded is not None:  # the whole leaves' gradients become the shards' (summed over the slabs), then go
                sharded.scatter_gradients(summed=spatial)
            if spatial:  # each slab gave a part of every whole gradient
                _sum_grads(params if sharded is None else sharded.replicated(), mesh, spatial_axis)
            updated = [p for g in state.optimizer.param_groups for p in g["params"]]
            if line is not None and data_size > 1:  # the data lines' gradients are averaged
                _sum_grads(updated, mesh, data_axis, 1.0 / data_size)
            grads = [p.grad for p in updated if p.grad is not None]
            if data_size > 1:  # equal shards: the mean of their mean losses is the batch's
                dist.all_reduce(loss, group=mesh.group(data_axis))
                loss = loss / data_size
            grad_norm = _grad_norm(state, grads)
            if state.grad_clip_norm is not None:
                clip_by_global_norm(grads, state.grad_clip_norm, norm=grad_norm)
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
