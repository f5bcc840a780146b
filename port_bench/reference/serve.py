"""Plain sliding-window inference with gaussian blending and the mean of the folds' sigmoids.

MONAI's ``sliding_window_inference`` as the bundles' ``inference.yaml`` runs
it (roi windows at ``roi * (1 - overlap)`` intervals, the last one flush with
the far edge, a gaussian importance map of sigma ``roi / 8`` floored at a
thousandth of its peak, blended sums divided by the blended weights; ``mode`` ``"constant"`` weighs every voxel alike), then
the fold ensemble: the mean over the folds of the sigmoid of each fold's
blended logits, and the mask ``mean > 0.5``.  Windows are predicted in groups
of ``sw_batch``; the forward is a reference family's ``forward(params, windows, net)``.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch


def importance_map(roi, mode: str = "gaussian") -> torch.Tensor:
    if mode == "constant":
        return torch.ones(tuple(roi), dtype=torch.float32)
    if mode != "gaussian":
        raise ValueError(f"blend mode {mode!r}: gaussian or constant")
    grids = []
    for s in roi:
        x = np.arange(s, dtype=np.float64)
        grids.append(np.exp(-0.5 * ((x - (s - 1) / 2.0) / (s * 0.125)) ** 2))
    out = grids[0]
    for g in grids[1:]:
        out = np.multiply.outer(out, g)
    return torch.from_numpy(np.maximum(out, out.max() * 1e-3).astype(np.float32))


def window_starts(size, roi, overlap: float) -> list[tuple]:
    per_axis = []
    for s, r in zip(size, roi):
        if r >= s:
            per_axis.append([0])
            continue
        step = max(int(r * (1.0 - overlap)), 1)
        n = int(math.ceil((s - r) / step)) + 1
        per_axis.append(sorted({min(i * step, s - r) for i in range(n)}))
    return list(itertools.product(*per_axis))


def windows_of(size, roi, overlap: float) -> int:
    return len(window_starts(size, roi, overlap))


@torch.no_grad()
def blended_logits(forward, weights: dict, net: dict, image: torch.Tensor, roi, sw_batch: int, overlap: float,
                   mode: str = "gaussian") -> torch.Tensor:
    """The blended logits ``(1, C_out, *S)`` of one network over ``image (1, C_in, *S)`` (no padding: S >= roi)."""
    size = image.shape[2:]
    if any(s < r for s, r in zip(size, roi)):
        raise ValueError(f"the reference takes volumes at least the roi, got {tuple(size)} < {tuple(roi)}")
    imp = importance_map(roi, mode).to(image.device, image.dtype)
    starts = window_starts(size, roi, overlap)
    out = weight = None
    for g in range(0, len(starts), sw_batch):
        group = starts[g:g + sw_batch]
        padded = group + [group[-1]] * (sw_batch - len(group))
        wins = torch.stack([image[(0, slice(None), *(slice(a, a + r) for a, r in zip(st, roi)))] for st in padded])
        logits = forward(weights, wins, net)
        if out is None:
            out = torch.zeros((1, logits.shape[1], *size), dtype=logits.dtype, device=image.device)
            weight = torch.zeros((1, 1, *size), dtype=logits.dtype, device=image.device)
        for j, st in enumerate(group):
            win = tuple(slice(a, a + r) for a, r in zip(st, roi))
            out[(0, slice(None), *win)] += logits[j] * imp
            weight[(0, slice(None), *win)] += imp
    return out / weight.clamp_min(1e-8)


def ensemble_probs(forward, folds: list, net: dict, image: torch.Tensor, roi, sw_batch: int, overlap: float,
                   mode: str = "gaussian") -> torch.Tensor:
    """The mean over ``folds`` (dicts of tensors) of the sigmoid of their blended logits."""
    total = None
    for weights in folds:
        p = torch.sigmoid(blended_logits(forward, weights, net, image, roi, sw_batch, overlap, mode))
        total = p if total is None else total + p
    return total / len(folds)
