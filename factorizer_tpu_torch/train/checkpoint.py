"""Checkpoint save and restore with ``torch.save`` / ``torch.load``.

PyTorch counterpart of ``factorizer_tpu/train/checkpoint.py`` (reference:
model_zoo/factorizer_brats23/configs/train.yaml:354-374; scripts/utils.py:10-31):
saves ``{step, model, optimizer}`` (the model's and the optimiser's
``state_dict``) with retention, restores the latest to resume, and loads
several fold checkpoints for ensembling (inference.yaml:13,141-152).

A checkpoint is one file, ``<directory>/step_<step>.pt``, written under a
temporary name and renamed into place, so a reader never sees half of one.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Optional

import torch

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint", "load_checkpoints"]

_PREFIX, _SUFFIX = "step_", ".pt"


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` whose tensors are new host tensors: later in-place updates of the originals cannot reach it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _to_savable(state: Any) -> Any:
    """TrainState -> ``{"step", "model", "optimizer"}`` (its ``state_dict()``, whole: collective where the state is
    sharded, so a sharded run passes that dict, made on every process); a module -> its ``state_dict``; anything
    else as it is."""
    if hasattr(state, "optimizer") and hasattr(state, "model"):
        return state.state_dict()
    if isinstance(state, torch.nn.Module):
        return state.state_dict()
    return state


def _write(path: Path, payload: Any) -> None:
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _load_into(template: Any, payload: Any) -> Any:
    """Load ``payload`` into a TrainState or module ``template`` in place and return the template."""
    if hasattr(template, "optimizer") and hasattr(template, "model"):
        return template.load_state_dict(payload)
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(payload["model"] if "model" in payload else payload)
        return template
    raise TypeError(f"cannot restore into a {type(template).__name__}")


def _map_location(template: Any):
    """The template's device, or the host without a template."""
    if template is None:
        return "cpu"
    model = template.model if hasattr(template, "model") else template
    return next(iter(model.state_dict().values())).device


class CheckpointManager:
    """Checkpoints of one run in ``directory``, with retention of ``max_to_keep`` (None keeps all).

    By default the latest ``max_to_keep`` are kept.  ``best_metric_key``
    keeps instead the ``max_to_keep`` with the highest value of that metric
    (saves pass ``metrics={key: value}``; one without it ranks below every one
    with it): MONAI's ``save_key_metric`` policy over the bundles' interval
    saver (train.yaml:368-374).

    Every metric passed to :meth:`save` is also written to ``metrics.json``
    beside the checkpoints, kept for deleted checkpoints too, so that
    :meth:`best_saved_metric` is the best over every validation of the run.
    """

    def __init__(self, directory: str | Path, max_to_keep: Optional[int] = 1,
                 best_metric_key: Optional[str] = None) -> None:
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric_key = best_metric_key
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # Per save: step, seconds in save() (the copy to the host) and seconds of the write behind it.
        self.timings: list[dict] = []

    def _path(self, step: int) -> Path:
        return self.directory / f"{_PREFIX}{int(step)}{_SUFFIX}"

    def all_steps(self) -> list[int]:
        """The steps of the checkpoints on disk, ascending (an unfinished write is not one)."""
        steps = []
        for p in self.directory.glob(f"{_PREFIX}*{_SUFFIX}"):
            digits = p.name[len(_PREFIX) : -len(_SUFFIX)]
            if digits.isdigit():
                steps.append(int(digits))
        return sorted(steps)

    def save(self, step: int, state: Any, metrics: Optional[dict] = None, block: bool = True) -> None:
        """Save a TrainState (or a module, or a dict of tensors) as ``step``.

        The tensors are copied to the host before this returns, so the next
        step's in-place update cannot race with the write.  ``block=False``
        writes the file and applies the retention in a background thread; call
        :meth:`wait` before relying on the file.  One write runs at a time: a
        save waits for the one before it.
        """
        t0 = time.perf_counter()
        self.wait()
        payload = _to_host(_to_savable(state))
        if metrics is not None:
            self._record_metrics(step, metrics)
        record = {"step": int(step), "blocking_s": 0.0, "background_s": 0.0}
        self.timings.append(record)

        def write() -> None:
            t1 = time.perf_counter()
            try:
                _write(self._path(step), payload)
                self._apply_retention()
            except Exception as exc:  # handed to the caller by wait()
                self._error = exc
            record["background_s"] = time.perf_counter() - t1

        if block:
            write()
            record["blocking_s"] = time.perf_counter() - t0 - record["background_s"]
            self.wait()
            return
        self._thread = threading.Thread(target=write, name="checkpoint-write", daemon=True)
        self._thread.start()
        record["blocking_s"] = time.perf_counter() - t0

    # The JSON sidecar of every metric ever reported: the trainer's watermark
    # is the best over every validation seen, not only over the checkpoints kept.
    @property
    def _metrics_path(self) -> Path:
        return self.directory / "metrics.json"

    def _read_metrics_log(self) -> dict:
        try:
            return json.loads(self._metrics_path.read_text())
        except (OSError, ValueError):
            return {}

    def _record_metrics(self, step: int, metrics: dict) -> None:
        log = self._read_metrics_log()
        log[str(int(step))] = {k: float(v) for k, v in metrics.items()}
        tmp = self._metrics_path.with_suffix(f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(log, indent=1))
        os.replace(tmp, self._metrics_path)

    def _apply_retention(self) -> None:
        if self.max_to_keep is None:
            return
        steps = self.all_steps()
        if self.best_metric_key is None:
            ranked = sorted(steps, reverse=True)
        else:
            log = self._read_metrics_log()

            def score(s: int) -> tuple:
                m = log.get(str(s), {})
                return (self.best_metric_key in m, float(m.get(self.best_metric_key, 0.0)), s)

            ranked = sorted(steps, key=score, reverse=True)
        for s in ranked[self.max_to_keep :]:
            self._path(s).unlink(missing_ok=True)

    def wait(self) -> None:
        """Block until the write in flight is on disk; raise what it raised, if anything."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def latest_step(self) -> Optional[int]:
        self.wait()  # a write in flight is the latest
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_saved_metric(self, key: str) -> Optional[float]:
        """The highest ``key`` over every metric recorded in this directory, or None if none carries it.

        A resumed trainer recovers its best-validation watermark from it, so
        its first validation after the resume is not counted as a new best.
        """
        self.wait()
        values = [float(m[key]) for m in self._read_metrics_log().values() if key in m]
        return max(values) if values else None

    def restore(self, step: Optional[int] = None, template: Any = None) -> Any:
        """The checkpoint at ``step`` (the latest if None), or None if there is none.

        With a TrainState or module ``template`` it is loaded into the
        template, on the template's device, and the template is returned.
        Without one the saved dict is returned with its tensors on the host.
        """
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return restore_checkpoint(self._path(step), template)

    def close(self) -> None:
        self.wait()


def save_checkpoint(path: str | Path, state: Any) -> None:
    """One blocking save of a TrainState, module or dict of tensors to ``path``."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    _write(path, _to_host(_to_savable(state)))


def restore_checkpoint(path: str | Path, template: Any = None) -> Any:
    """Load ``path``; into ``template`` where one is given (see :meth:`CheckpointManager.restore`)."""
    payload = torch.load(Path(path), map_location=_map_location(template), weights_only=True)
    return payload if template is None else _load_into(template, payload)


def load_checkpoints(paths: list[str | Path]) -> list[Any]:
    """Load several (k-fold) checkpoints for ensembled inference, each as its saved dict on the host."""
    return [restore_checkpoint(p) for p in paths]
