"""High-level training and evaluation loops.

PyTorch counterpart of ``factorizer_tpu/train/loop.py``: the replacement for
ignite's ``SupervisedTrainer`` / ``SupervisedEvaluator`` / ``EnsembleEvaluator``
and their handlers (reference: model_zoo/factorizer_brats23/configs/train.yaml:302-384,
inference.yaml:107-161).  An epoch loop over the train step, sliding-window
validation with Dice and HD95 every ``val_interval`` epochs, checkpoints with
resume, console and TensorBoard logging, and the mean of k fold checkpoints at
inference.

The loaders hand over numpy batches; the trainer moves each to the card
itself, from pinned host memory on a copy stream of its own, so that the copy
of one batch overlaps the step before it.  Labels travel as the loader's
integers (uint8) and images in the model's compute dtype; the losses stay on
the card and are read once an epoch.

Several processes (``torchrun``, one card or one gloo rank each) train one
model under ``mesh``: each loader holds its own shard of the datalist and
each batch is this process's block of the global batch (JAX's
``_device_batch``, ``factorizer_tpu/train/loop.py:222-276``); every process
validates its own ``val_loader`` and the metrics are averaged over the
processes; only the primary process writes checkpoints, the history and
TensorBoard files.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..parallel.mesh import Mesh, process_is_primary
from ..utils.helpers import materialize, resolve_device
from .checkpoint import CheckpointManager
from .metrics import MeanDice, MeanHausdorffDistance, dice_metric, voxel_spacing_from_meta
from .sliding_window import SlidingWindowInfererAdapt
from .trainer import TrainState, create_train_state, make_train_step

logger = logging.getLogger("factorizer_tpu_torch")

__all__ = ["SegmentationTrainer", "Evaluator", "EnsembleEvaluator"]


def _model_input_dtype(model: nn.Module) -> Optional[torch.dtype]:
    """The dtype a float32 image travels to the card in: the stem's compute dtype under amp, else None.

    The stem's first operation casts its input to that dtype, so casting on
    the host first gives the same bits and moves half the bytes in bf16.
    """
    dtype = getattr(getattr(model, "stem", None), "dtype", None)
    return dtype if isinstance(dtype, torch.dtype) else None


def _upload(array, device: torch.device, dtype: Optional[torch.dtype] = None,
            stream: Optional[torch.cuda.Stream] = None) -> torch.Tensor:
    """A numpy array (or tensor) on ``device``, cast to ``dtype`` on the host first.

    To the card the copy is made from pinned memory without blocking, on
    ``stream`` when one is given; the caller makes its stream wait for it.
    """
    t = torch.as_tensor(array)
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if t.device == device:
        return t
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    with torch.cuda.stream(stream) if stream is not None else torch.cuda.device(device):
        return t.pin_memory().to(device, non_blocking=True)


def _first(out):
    """The full-resolution logits of a deep-supervision pyramid, or the logits."""
    return out[0] if isinstance(out, (list, tuple)) else out


def _tensorboard_writer(log_dir: Path):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(str(log_dir))


def _check_equal_shards(train_loader) -> None:
    """Raise unless every process's loader holds as many cases and gives as many batches an epoch (collective)."""
    dataset = getattr(train_loader, "dataset", None)
    mine = (len(dataset) if hasattr(dataset, "__len__") else None, len(train_loader))
    sizes = [None] * dist.get_world_size()
    dist.all_gather_object(sizes, mine)
    if len(set(sizes)) > 1:
        raise ValueError(
            f"SegmentationTrainer: unequal shards: the processes' train loaders hold (cases, batches an epoch) {sizes}; "
            "a process with a step more would wait in the gradient all-reduce for a partner that has none. Give every "
            "process as many cases (a datalist whose length the process count divides, and under drop_last as many "
            "batches)")


class SegmentationTrainer:
    """Supervised segmentation training with periodic validation.

    Args:
        model: the network, a module (moved to ``device``) with ``forward(x)``.
        train_loader / val_loader: iterables of ``{"image", "label"}`` numpy
            batches, channels first.
        max_epochs, val_interval: the loop's schedule (reference defaults 300 / 20).
        lr, weight_decay, warmup_epochs: AdamW with a warm-up-cosine schedule
            over ``warmup_epochs`` and ``max_epochs`` epochs of steps.
        roi_size, sw_batch_size, overlap: the validation's sliding window.
        ckpt_dir: checkpoint directory; a run resumes from its latest checkpoint.
        log_dir: where ``history.jsonl`` and, if ``torch.utils.tensorboard``
            imports, the TensorBoard events go.
        ckpt_best: keep the ``max_to_keep`` checkpoints with the highest
            validation mean Dice instead of the latest (saves then happen only
            on validated epochs); a resume restarts from the best kept step.
        loss_fn: optional override of the DiceCE default.
        seed: seeds torch's generators (dropout) when :meth:`run` starts,
            folded with the step it starts from, so a resumed run draws on
            instead of replaying its first epochs.
        accum_steps: micro-batches a step (see ``make_train_step``).
        device: where the model trains; None is the card (raises without one),
            ``"cpu"`` runs on the CPU.
        mesh: a ``parallel.Mesh`` over the processes (``data_parallel_mesh()``,
            ``model_parallel_mesh()``); a mesh of one process trains as
            without one.  With more, every process builds the trainer with
            its own loaders: ``train_loader`` holds this process's shard of
            the training list (``partition_datalist`` over
            ``data_process_groups``) and gives its block of each global batch,
            which the step does not cut again.  The shards must be equal in
            cases and in batches an epoch, or the constructor raises: a
            process with a step more would wait in the gradient all-reduce for
            a partner that has none.  The first process's parameters go to the
            others; a resume reads the same directory on every process, and
            every host must see it (a shared file system; the primary alone
            writes it, as JAX's one writer does): where the processes would
            resume from different steps, :meth:`initialize` raises on every
            process before the first step, which they would otherwise take
            apart and then wait for each other in.
        model_axis, shard_spatial: as the JAX trainer takes them: with
            ``model_axis`` in ``mesh`` at a size above 1, the parameters that
            JAX's ``param_sharding_rules`` cuts are held sharded over that
            axis, with their AdamW moments (``create_train_state(mesh=,
            model_axis=)``; the step gathers them whole for the forward and
            the backward).  With ``shard_spatial`` the step is the spatial
            step over that axis (``make_train_step``'s ``spatial_axis``): the
            processes of a ``model`` line train on slabs of one batch, the
            first process's; without it every process of a line runs the
            whole model on that batch (``make_train_step``'s ``model_axis``):
            the state is sharded, the activations are not, unlike GSPMD's.
            A ``model`` axis of size 1 (one process) is the plain step.
            Validation gathers the weights once on every process and frees
            them after; a checkpoint is gathered on every process and written
            whole, in a one-process run's format, by the primary, and a
            resume reads the whole file and keeps this process's part.
        tp_min_weight_size: the rule's ``min_weight_size``: a leaf of fewer
            elements stays whole.
    """

    def __init__(
        self,
        model: nn.Module,
        train_loader,
        val_loader=None,
        max_epochs: int = 300,
        val_interval: int = 20,
        lr: float = 1e-3,
        weight_decay: float = 1e-2,
        warmup_epochs: int = 5,
        roi_size: Sequence[int] = (128, 128, 128),
        sw_batch_size: int = 2,
        overlap: float = 0.5,
        ckpt_dir: Optional[str] = None,
        log_dir: Optional[str] = None,
        loss_fn: Optional[Callable] = None,
        mesh=None,
        seed: int = 123,
        compute_hd95: bool = False,
        max_to_keep: int = 1,
        ckpt_best: bool = False,
        accum_steps: int = 1,
        model_axis: Optional[str] = None,
        shard_spatial: bool = False,
        tp_min_weight_size: int = 2**14,
        device=None,
    ) -> None:
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"SegmentationTrainer: mesh must be a factorizer_tpu_torch.parallel.Mesh, got {type(mesh).__name__}")
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._model_axis = (model_axis if self.mesh is not None and model_axis is not None
                            and model_axis in self.mesh.shape and self.mesh.axis_size(model_axis) > 1 else None)
        self._spatial_axis = self._model_axis if shard_spatial else None
        self._tp_min_weight_size = tp_min_weight_size
        self._primary = process_is_primary()
        self.device = resolve_device(device)
        self.model = materialize(model, len(roi_size)).to(self.device)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.max_epochs = max_epochs
        self.val_interval = val_interval
        self.roi_size = tuple(roi_size)
        self.sw_batch_size = sw_batch_size
        self.overlap = overlap
        self.seed = seed
        self.compute_hd95 = compute_hd95
        self._input_dtype = _model_input_dtype(self.model)
        # Validation inferer with out-of-memory degradation (reference train.yaml:206-212
        # uses SlidingWindowInfererAdapt); its rung holds across validations.
        self._inferer = SlidingWindowInfererAdapt(self.roi_size, sw_batch_size=sw_batch_size, overlap=overlap)

        steps_per_epoch = max(len(train_loader), 1)
        self._optimizer_settings = dict(
            lr=lr, weight_decay=weight_decay,
            warmup_steps=warmup_epochs * steps_per_epoch, total_steps=max_epochs * steps_per_epoch,
        )
        if self.mesh is not None:
            _check_equal_shards(train_loader)
        self.train_step = make_train_step(self.model, loss_fn=loss_fn, accum_steps=accum_steps, mesh=self.mesh,
                                          spatial_axis=self._spatial_axis, local_batch=True,
                                          model_axis=None if self._spatial_axis else self._model_axis)
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        self._ckpt_best = bool(ckpt_best and val_loader is not None)
        # The other processes only read the directory (to resume), and only one that is there: making it is a write.
        self._ckpt_dir = ckpt_dir
        self.ckpt = (
            CheckpointManager(ckpt_dir, max_to_keep=max_to_keep,
                              best_metric_key="mean_dice" if self._ckpt_best else None)
            if ckpt_dir and (self._primary or Path(ckpt_dir).is_dir()) else None
        )
        self.log_dir = Path(log_dir) if log_dir and self._primary else None
        self._tb = None
        if self.log_dir:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._tb = _tensorboard_writer(self.log_dir)

        self.state: Optional[TrainState] = None
        self.history: list[dict] = []
        # Per epoch: seconds waiting on the loader, the steps' device seconds
        # (CUDA events; None on the CPU), validation and checkpoint seconds.
        self.timings: list[dict] = []
        self.best_metric = -float("inf")

    # -- lifecycle

    def initialize(self) -> TrainState:
        """Build the train state (AdamW, schedule) and resume from the latest checkpoint, if there is one."""
        n_params = sum(p.numel() for p in self.model.parameters())
        self.state = create_train_state(self.model, device=self.device, mesh=self.mesh, model_axis=self._model_axis,
                                        min_weight_size=self._tp_min_weight_size, **self._optimizer_settings)
        if self._primary:
            logger.info("model parameters: %.2fM", n_params / 1e6)
            if self.state.shards is not None:
                logger.info("%d parameters sharded over %r", len(self.state.shards.names), self._model_axis)
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            self.ckpt.restore(template=self.state)
            # The best-validation watermark, so that the first validation after
            # the resume does not count as a new best.
            saved_best = self.ckpt.best_saved_metric("mean_dice")
            if saved_best is not None:
                self.best_metric = saved_best
            if self._primary:
                logger.info("resumed from checkpoint step %s (best mean_dice %s)", self.state.step, saved_best)
        if self.mesh is not None:
            steps = [None] * dist.get_world_size()
            dist.all_gather_object(steps, int(self.state.step))
            if len(set(steps)) > 1:
                raise RuntimeError(
                    f"SegmentationTrainer: the processes would resume from different steps of the checkpoint "
                    f"directory {self._ckpt_dir!r}, by rank {steps}: every host must see that directory (a shared "
                    "file system), since the primary process alone writes it")
        return self.state

    def _device_batch(self, batch: dict) -> dict:
        """A numpy batch on the device: images in the model's input dtype, integer labels as they are.

        One-hot labels travel as the loader's uint8 (the loss casts them on the
        device, exactly), a quarter of the bytes of float32.
        """
        label = np.asarray(batch["label"])
        if not np.issubdtype(label.dtype, np.integer):
            label = np.asarray(label, np.float32)
        out = {"image": _upload(batch["image"], self.device, self._input_dtype, self._copy_stream),
               "label": _upload(label, self.device, None, self._copy_stream)}
        if self._copy_stream is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_stream(self._copy_stream)
            for t in out.values():
                t.record_stream(main)  # the copy stream may not reuse the memory before the step is done with it
        return out

    def _log(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def _predict(self, windows: torch.Tensor) -> torch.Tensor:
        return _first(self.model(windows))

    # -- validation

    @torch.inference_mode()
    def validate(self) -> dict:
        assert self.state is not None
        self.model.eval()
        dice = MeanDice()
        hd = MeanHausdorffDistance() if self.compute_hd95 else None
        logged_images = False
        for batch in self.val_loader:
            images = _upload(batch["image"], self.device, self._input_dtype)
            labels = np.asarray(batch["label"])
            logits = self._inferer(images, self._predict)
            # sigmoid(x) > 0.5 is x > 0: threshold on the card, fetch uint8.
            preds = (logits > 0).to(torch.uint8).cpu().numpy()
            dice.update(preds, labels)
            if hd is not None:
                metas = batch.get("image_meta")
                hd.update(preds, labels, spacing=voxel_spacing_from_meta(metas[0]) if metas else None)
            if not logged_images and self._tb is not None:
                # TensorBoardImageHandler analogue (reference train.yaml:296-300).
                from .observability import log_validation_images

                log_validation_images(self._tb, images.float().cpu().numpy(), labels, preds, step=self.state.step)
                logged_images = True
        out = {"mean_dice": dice.compute()}
        for c, v in enumerate(dice.compute_per_channel()):
            out[f"dice_ch{c}"] = float(v)
        if hd is not None:
            out["hd95"] = hd.compute()
        return out

    # -- main loop

    def run(self) -> TrainState:
        if self.state is None:
            self.initialize()
        state = self.state
        steps_per_epoch = max(len(self.train_loader), 1)
        start_epoch = state.step // steps_per_epoch  # resume at the epoch the restored step implies
        torch.manual_seed(self.seed + 1 + state.step)
        on_card = self.device.type == "cuda"
        if on_card:
            # cuDNN times its algorithms per shape, as suits a run of fixed shapes: without it
            # the stem's float32 weight gradient takes a 92 ms kernel.
            torch.backends.cudnn.benchmark = True
        for epoch in range(start_epoch, self.max_epochs):
            if hasattr(self.train_loader, "set_epoch"):
                self.train_loader.set_epoch(epoch)
            t0 = time.time()
            losses, events = [], []
            loader_wait = 0.0
            batches = iter(self.train_loader)
            while True:
                t_wait = time.perf_counter()
                batch = next(batches, None)
                loader_wait += time.perf_counter() - t_wait
                if batch is None:
                    break
                batch = self._device_batch(batch)
                if on_card:
                    events.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
                    events[-1][0].record()
                state, metrics = self.train_step(state, batch)
                if on_card:
                    events[-1][1].record()
                losses.append(metrics["loss"])
            self.state = state
            epoch_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            dt = time.time() - t0
            timing = {"epoch": epoch, "steps": len(losses), "loader_wait_s": loader_wait,
                      "step_device_s": sum(a.elapsed_time(b) for a, b in events) / 1e3 if on_card else None}
            if self._primary:
                logger.info("epoch %d/%d loss=%.4f (%.1fs)", epoch + 1, self.max_epochs, epoch_loss, dt)
            self._log("train/loss", epoch_loss, epoch)

            record = {"epoch": epoch, "loss": epoch_loss, "time_s": dt}

            val_metrics = None
            if self.val_loader is not None and self.val_interval and (epoch + 1) % self.val_interval == 0:
                t_val = time.perf_counter()
                # A sharded state's weights are gathered once, on every process, whatever its loader's length.
                with state.shards.gathered() if state.shards is not None else contextlib.nullcontext():
                    val_metrics = self.validate()
                if self.mesh is not None:
                    # Each process validated its own loader: the mean over the processes (NaN where a process has
                    # none), so that the log, the best metric and the best checkpoints agree on every process.
                    gathered = [None] * dist.get_world_size()
                    dist.all_gather_object(gathered, val_metrics)
                    val_metrics = {k: float(np.nanmean([np.float64(m[k]) for m in gathered])) for k in val_metrics}
                timing["val_s"] = time.perf_counter() - t_val
                record.update(val_metrics)
                if self._primary:
                    logger.info("validation @ epoch %d: %s", epoch + 1, val_metrics)
                for k, v in val_metrics.items():
                    self._log(f"val/{k}", v, epoch)
                if val_metrics["mean_dice"] > self.best_metric:
                    self.best_metric = val_metrics["mean_dice"]

            # Best-by-metric retention saves only validated epochs; latest retention saves every epoch and still
            # records the metric, so that best_metric survives a resume.
            if self._ckpt_dir and (not self._ckpt_best or val_metrics is not None):
                # Whole: a sharded state is gathered on every process (collective); the primary writes it.
                payload = state.state_dict()
                if self.ckpt is not None and self._primary:
                    # The write overlaps the next epoch; the tensors are on the host before save() returns.
                    metrics = {"mean_dice": float(val_metrics["mean_dice"])} if val_metrics is not None else None
                    self.ckpt.save(epoch + 1, payload, metrics=metrics, block=False)
                    timing["ckpt_blocking_s"] = self.ckpt.timings[-1]["blocking_s"]
                del payload

            self.history.append(record)
            self.timings.append(timing)
            if self.log_dir:
                with (self.log_dir / "history.jsonl").open("a") as f:
                    f.write(json.dumps(record) + "\n")

        if self.ckpt is not None:
            self.ckpt.wait()  # the last epoch's save is on disk before this returns
        if self._tb is not None:
            self._tb.flush()
        if self.mesh is not None:
            dist.barrier()  # on every process too: a trainer resuming from the directory next reads the last save
        return state


class Evaluator:
    """Sliding-window evaluation of one model over a loader.

    ``variables`` are the weights to evaluate: a ``state_dict``, a checkpoint
    as :func:`~.checkpoint.load_checkpoints` returns it (its ``"model"``), or
    None for the model's own.  They are applied with ``torch.func.functional_call``,
    as the JAX evaluator applies its variables, so ``model`` itself is not
    changed and several evaluators can share one.
    """

    def __init__(
        self,
        model: nn.Module,
        variables: Optional[dict] = None,
        roi_size: Sequence[int] = (128, 128, 128),
        sw_batch_size: int = 2,
        overlap: float = 0.5,
        compute_hd95: bool = True,
        postprocess: Optional[Callable] = None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.model = materialize(model, len(roi_size)).to(self.device)
        if variables is not None and "model" in variables and "optimizer" in variables:
            variables = variables["model"]
        self.variables = None if variables is None else {k: v.to(self.device) for k, v in variables.items()}
        self.roi_size = tuple(roi_size)
        self.sw_batch_size = sw_batch_size
        self.overlap = overlap
        self.compute_hd95 = compute_hd95
        self.postprocess = postprocess
        self._input_dtype = _model_input_dtype(self.model)
        self._inferer = SlidingWindowInfererAdapt(self.roi_size, sw_batch_size=sw_batch_size, overlap=overlap)

    def _apply(self, windows: torch.Tensor) -> torch.Tensor:
        if self.variables is None:
            return _first(self.model(windows))
        return _first(torch.func.functional_call(self.model, self.variables, (windows,)))

    @torch.inference_mode()
    def predict(self, images) -> torch.Tensor:
        """Blended float32 logits ``(B, C_out, *S)`` on the device."""
        self.model.eval()
        return self._inferer(_upload(images, self.device, self._input_dtype), self._apply)

    def predict_mask(self, images) -> np.ndarray:
        """Sliding-window inference thresholded on the device (logits > 0), fetched as uint8."""
        return (self.predict(images) > 0).to(torch.uint8).cpu().numpy()

    def run(self, loader, save_case_metrics: Optional[str] = None) -> dict:
        dice = MeanDice()
        hd = MeanHausdorffDistance() if self.compute_hd95 else None
        cases = []
        for batch in loader:
            preds = self.predict_mask(batch["image"])
            labels = np.asarray(batch["label"])
            dice.update(preds, labels)
            if hd is not None:
                metas = batch.get("image_meta")
                hd.update(preds, labels, spacing=voxel_spacing_from_meta(metas[0]) if metas else None)
            case_dice = np.nanmean(np.asarray(dice_metric(preds, labels)))
            cases.append({"id": batch.get("id", [None])[0], "dice": float(case_dice)})
        out = {"mean_dice": dice.compute()}
        if hd is not None:
            out["hd95"] = hd.compute()
        if save_case_metrics:
            Path(save_case_metrics).parent.mkdir(parents=True, exist_ok=True)
            with open(save_case_metrics, "w") as f:
                json.dump(cases, f, indent=2)
        return out


class EnsembleEvaluator:
    """Mean ensemble of k fold checkpoints (reference: inference.yaml:107-152)."""

    def __init__(
        self,
        model: nn.Module,
        variables_list: Sequence[Any],
        roi_size: Sequence[int] = (128, 128, 128),
        sw_batch_size: int = 2,
        overlap: float = 0.5,
        device=None,
    ) -> None:
        self.evaluators = [
            Evaluator(model, v, roi_size, sw_batch_size, overlap, compute_hd95=False, device=device)
            for v in variables_list
        ]

    @torch.inference_mode()
    def predict(self, images) -> np.ndarray:
        """The mean over the fold models of their sigmoid probabilities, on the host."""
        probs = None
        for ev in self.evaluators:
            p = torch.sigmoid(ev.predict(images))
            probs = p if probs is None else probs + p
        return (probs / len(self.evaluators)).cpu().numpy()
