"""Sliding-window inference with gaussian blending.

PyTorch counterpart of ``compute_importance_map``, ``sliding_window_positions``
and ``sliding_window_inference`` in ``factorizer_tpu/train/sliding_window.py``
(MONAI's scheme: roi windows at ``roi * (1 - overlap)`` intervals, blended by
a gaussian importance map).  The window starts are computed on the host; a
host loop over groups of ``sw_batch_size`` windows gathers each group from
the padded volume, predicts, and blend-accumulates into float32 sums on the
volume's device.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["compute_importance_map", "sliding_window_positions", "sliding_window_inference"]


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
    predictor: Callable[[torch.Tensor], torch.Tensor],
    sw_batch_size: int = 4,
    overlap: float = 0.5,
    mode: str = "gaussian",
    pad_value: float = 0.0,
) -> torch.Tensor:
    """Run ``predictor`` over overlapping windows of ``inputs (B, C, *S)``, blended by
    :func:`compute_importance_map` in ``mode`` (``"gaussian"`` or ``"constant"``).

    ``predictor`` maps ``(n, C, *roi)`` to ``(n, C_out, *roi)``.  A volume
    smaller than the roi is padded up to it with ``pad_value``.  The last
    group is filled up by repeating its final window, whose extra predictions
    are dropped, so every call sees ``sw_batch_size`` windows.  Returns the
    blended float32 ``(B, C_out, *S)``.
    """
    batch, _, *spatial = inputs.shape
    roi = tuple(roi_size)
    pad = []
    for r, s in zip(reversed(roi), reversed(spatial)):  # F.pad lists the last axis first
        pad += [0, max(r - s, 0)]
    padded = F.pad(inputs, pad, value=pad_value)
    pspatial = padded.shape[2:]

    importance = torch.from_numpy(compute_importance_map(roi, mode)).to(inputs.device)
    jobs = [(b, *pos) for b in range(batch) for pos in sliding_window_positions(pspatial, roi, overlap)]
    out_sum = weight_sum = None
    for g0 in range(0, len(jobs), sw_batch_size):
        group = jobs[g0 : g0 + sw_batch_size]
        n_valid = len(group)
        group = group + [group[-1]] * (sw_batch_size - n_valid)
        windows = torch.stack(
            [padded[(b, slice(None), *(slice(s, s + r) for s, r in zip(start, roi)))] for b, *start in group]
        )
        preds = predictor(windows)
        if out_sum is None:
            out_sum = torch.zeros((batch, preds.shape[1], *pspatial), dtype=torch.float32, device=inputs.device)
            weight_sum = torch.zeros((batch, 1, *pspatial), dtype=torch.float32, device=inputs.device)
        for j, (b, *start) in enumerate(group[:n_valid]):
            win = tuple(slice(s, s + r) for s, r in zip(start, roi))
            out_sum[(b, slice(None), *win)] += preds[j].float() * importance
            weight_sum[(b, slice(None), *win)] += importance
    result = out_sum / weight_sum.clamp_min(1e-8)
    return result[(slice(None), slice(None), *(slice(0, s) for s in spatial))]
