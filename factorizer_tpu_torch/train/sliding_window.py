"""Sliding-window inference with gaussian blending.

PyTorch counterpart of ``compute_importance_map``, ``sliding_window_positions``
and ``sliding_window_inference`` in ``factorizer_tpu/train/sliding_window.py``
(MONAI's scheme: roi windows at ``roi * (1 - overlap)`` intervals, blended by
a gaussian importance map).  The window starts are computed on the host; a
host loop over groups of ``sw_batch_size`` windows gathers each group from
the padded volume, predicts, and blend-accumulates into float32 sums on the
volume's device, or with ``stitch_on_host`` into numpy sums on the host.
Under a profiler these phases show as spans (``utils.profiling.span``):
``sliding_window.prepare``, then per group ``.gather``, ``.predict`` and
``.blend``, and ``.normalize``.

:class:`SlidingWindowInfererAdapt` is the counterpart of the JAX package's
class of that name (MONAI's ``SlidingWindowInfererAdapt``, the bundles'
validation inferer): on the card's out-of-memory error it steps down from
device sums to host sums, then halves ``sw_batch_size`` down to 1.  Every rung
runs the predictor on the volume's device; only the blending moves.
"""

from __future__ import annotations

import itertools
import math
import warnings
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span

__all__ = ["compute_importance_map", "sliding_window_positions", "sliding_window_inference", "SlidingWindowInfererAdapt"]


def compute_importance_map(roi_size: Sequence[int], mode: str = "gaussian", sigma_scale: float = 0.125) -> np.ndarray:
    """Per-window blending weights, float32: ones for ``mode="constant"``, else a gaussian centred in
    the window with sigma = roi * ``sigma_scale``."""
    if mode == "constant":
        return np.ones(tuple(roi_size), dtype=np.float32)
    grids = []
    for s in roi_size:
        center = (s - 1) / 2.0
        sigma = max(s * sigma_scale, 1e-3)
        x = np.arange(s, dtype=np.float64)
        grids.append(np.exp(-0.5 * ((x - center) / sigma) ** 2))
    out = np.asarray(grids[0])
    for g in grids[1:]:
        out = np.multiply.outer(out, g)
    out = np.maximum(out, out.max() * 1e-3)  # no zero weight at the corners
    return out.astype(np.float32)


def sliding_window_positions(
    image_size: Sequence[int], roi_size: Sequence[int], overlap: float = 0.5
) -> list[tuple[int, ...]]:
    """Window start offsets covering the volume."""
    starts_per_dim = []
    for size, roi in zip(image_size, roi_size):
        if roi >= size:
            starts_per_dim.append([0])
            continue
        interval = max(int(roi * (1.0 - overlap)), 1)
        n = int(math.ceil((size - roi) / interval)) + 1
        starts = [min(i * interval, size - roi) for i in range(n)]
        starts_per_dim.append(list(dict.fromkeys(starts)))
    return [tuple(p) for p in itertools.product(*starts_per_dim)]


def sliding_window_inference(
    inputs: torch.Tensor,
    roi_size: Sequence[int],
    predictor: Callable[..., torch.Tensor],
    sw_batch_size: int = 4,
    overlap: float = 0.5,
    mode: str = "gaussian",
    pad_value: float = 0.0,
    predictor_args: Sequence[Any] = (),
    stitch_on_host: bool = False,
) -> torch.Tensor:
    """Run ``predictor`` over overlapping windows of ``inputs (B, C, *S)``, blended by
    :func:`compute_importance_map` in ``mode`` (``"gaussian"`` or ``"constant"``).

    ``predictor(windows, *predictor_args)`` maps ``(n, C, *roi)`` to
    ``(n, C_out, *roi)``.  A volume smaller than the roi is padded up to it
    with ``pad_value``.  The last group is filled up by repeating its final
    window, whose extra predictions are dropped, so every call sees
    ``sw_batch_size`` windows.  Returns the blended float32 ``(B, C_out, *S)``
    on the device of ``inputs``.

    ``stitch_on_host`` keeps the two blending sums in host memory: each
    group's predictions are copied to the host and added there, so the device
    holds the padded input and one group's windows instead of two more
    float32 volumes.  Either way the sums take the same float32 operations in
    the same order.
    """
    batch, _, *spatial = inputs.shape
    roi = tuple(roi_size)
    with span("sliding_window.prepare"):
        pad = []
        for r, s in zip(reversed(roi), reversed(spatial)):  # F.pad lists the last axis first
            pad += [0, max(r - s, 0)]
        padded = F.pad(inputs, pad, value=pad_value)
        pspatial = padded.shape[2:]

        importance_np = compute_importance_map(roi, mode)
        importance = importance_np if stitch_on_host else torch.from_numpy(importance_np).to(inputs.device)
        jobs = [(b, *pos) for b in range(batch) for pos in sliding_window_positions(pspatial, roi, overlap)]
    out_sum = weight_sum = None
    for g0 in range(0, len(jobs), sw_batch_size):
        group = jobs[g0 : g0 + sw_batch_size]
        n_valid = len(group)
        group = group + [group[-1]] * (sw_batch_size - n_valid)
        with span("sliding_window.gather"):
            windows = torch.stack(
                [padded[(b, slice(None), *(slice(s, s + r) for s, r in zip(start, roi)))] for b, *start in group]
            )
        with span("sliding_window.predict"):
            preds = predictor(windows, *predictor_args).float()
            if stitch_on_host:
                preds = preds.cpu().numpy()
        with span("sliding_window.blend"):
            if out_sum is None:
                shape = (batch, preds.shape[1], *pspatial), (batch, 1, *pspatial)
                if stitch_on_host:
                    out_sum, weight_sum = (np.zeros(sh, np.float32) for sh in shape)
                else:
                    out_sum, weight_sum = (torch.zeros(sh, dtype=torch.float32, device=inputs.device) for sh in shape)
            for j, (b, *start) in enumerate(group[:n_valid]):
                win = tuple(slice(s, s + r) for s, r in zip(start, roi))
                out_sum[(b, slice(None), *win)] += preds[j] * importance
                weight_sum[(b, slice(None), *win)] += importance
    with span("sliding_window.normalize"):
        if stitch_on_host:
            result = torch.from_numpy(out_sum / np.maximum(weight_sum, np.float32(1e-8))).to(inputs.device)
        else:
            result = out_sum / weight_sum.clamp_min(1e-8)
        return result[(slice(None), slice(None), *(slice(0, s) for s in spatial))]


class SlidingWindowInfererAdapt:
    """Sliding-window inference that steps down on the card's out-of-memory error.

    The rungs, tried in turn from where the last call ended:

    1. blending sums on the volume's device (:func:`sliding_window_inference`);
    2. blending sums on the host (``stitch_on_host``): one window group on the device;
    3. host sums with ``sw_batch_size`` halved, again on each error, down to 1.

    The rung reached is kept for later calls, so a long evaluation pays for
    the failed attempts once.  Only ``torch.cuda.OutOfMemoryError`` moves it
    down, with a warning; any other error, and the error at the last rung,
    propagate.  The predictor runs on the volume's device at every rung.
    """

    def __init__(self, roi_size: Sequence[int], sw_batch_size: int = 4, overlap: float = 0.5,
                 mode: str = "gaussian") -> None:
        self.roi_size = tuple(roi_size)
        self.sw_batch_size = sw_batch_size
        self.overlap = overlap
        self.mode = mode
        self._stitch_on_host = False
        self._sw_batch = sw_batch_size

    def __call__(self, inputs: torch.Tensor, predictor: Callable[..., torch.Tensor],
                 predictor_args: Sequence[Any] = (), **kw) -> torch.Tensor:
        while True:
            try:
                return sliding_window_inference(
                    inputs, self.roi_size, predictor, sw_batch_size=self._sw_batch, overlap=self.overlap,
                    mode=self.mode, predictor_args=predictor_args, stitch_on_host=self._stitch_on_host, **kw,
                )
            except torch.cuda.OutOfMemoryError:
                if self._stitch_on_host and self._sw_batch == 1:
                    raise
            # Out of the handler, so the failed attempt's tensors are free before the retry.
            if inputs.is_cuda:
                torch.cuda.empty_cache()
            if not self._stitch_on_host:
                self._stitch_on_host = True
                warnings.warn("sliding-window inference ran out of device memory; retrying with host-stitched blending")
            else:
                self._sw_batch = max(1, self._sw_batch // 2)
                warnings.warn(f"sliding-window inference ran out of device memory; retrying with sw_batch_size={self._sw_batch}")
