"""Segmentation metrics: Dice and the 95th-percentile Hausdorff distance.

PyTorch counterpart of ``factorizer_tpu/train/metrics.py`` (reference:
model_zoo/factorizer_brats23/scripts/metrics.py:7-45 wrapping
``monai.metrics.{DiceMetric,HausdorffDistanceMetric}``).  Dice takes numpy
masks on the host, as the trainer fetches them, or tensors where a mask is
still one (on the card, or the CPU); HD95 runs on the host through scipy's
distance transforms, as surface distances depend on the data.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

try:
    from scipy import ndimage as _ndi
except ImportError:  # pragma: no cover
    _ndi = None

__all__ = [
    "dice_metric",
    "MeanDice",
    "hausdorff_distance_95",
    "MeanHausdorffDistance",
    "voxel_spacing_from_meta",
]

Mask = Union[np.ndarray, torch.Tensor]


def voxel_spacing_from_meta(meta) -> Optional[tuple]:
    """Voxel spacing (mm per voxel) from an image meta dict's affine.

    The transform pipeline keeps ``<key>_meta["affine"]`` current through
    Spacingd/Orientationd/Invertd, so the column norms of its rotation block
    are the spacing of whatever grid the arrays are on now: 1 mm after a 1 mm
    Spacingd, native after Invertd.  None when no usable affine is present.
    """
    if not isinstance(meta, dict):
        return None
    aff = meta.get("affine")
    if aff is None:
        return None
    aff = np.asarray(aff, dtype=np.float64)
    if aff.ndim != 2 or aff.shape[0] < 2:
        return None
    n = aff.shape[0] - 1
    return tuple(np.sqrt((aff[:n, :n] ** 2).sum(axis=0)))


def dice_metric(
    pred: Mask,
    target: Mask,
    include_background: bool = True,
    ignore_empty: bool = False,
    channel_axis: int = 1,
) -> Mask:
    """Per-sample, per-channel hard Dice on binary masks ``(B, C, *S)``, as ``(B, C)``.

    ``ignore_empty`` has MONAI ``DiceMetric``'s meaning.  True: NaN where the
    ground truth is empty (left out of the mean downstream).  False (the
    bundles' setting, train.yaml ``ignore_empty: false``): an empty
    ground-truth channel scores 1.0 if the prediction is empty too, else 0.0.

    Two numpy masks give a float64 numpy result; otherwise both are taken as
    tensors on one device and the result is a float64 tensor there.
    """
    if isinstance(pred, np.ndarray) and isinstance(target, np.ndarray):
        if not include_background:
            pred = np.take(pred, np.arange(1, pred.shape[channel_axis]), axis=channel_axis)
            target = np.take(target, np.arange(1, target.shape[channel_axis]), axis=channel_axis)
        axes = tuple(range(2, pred.ndim))
        intersection = np.sum(pred * target, axis=axes, dtype=np.float64)
        pred_o = np.sum(pred, axis=axes, dtype=np.float64)
        target_o = np.sum(target, axis=axes, dtype=np.float64)
        dice = (2.0 * intersection) / np.maximum(pred_o + target_o, 1e-12)
        if ignore_empty:
            return np.where(target_o > 0, dice, np.nan)
        return np.where(target_o > 0, dice, np.where(pred_o > 0, 0.0, 1.0))

    pred, target = torch.as_tensor(pred), torch.as_tensor(target)
    if not include_background:
        pred = pred.narrow(channel_axis, 1, pred.shape[channel_axis] - 1)
        target = target.narrow(channel_axis, 1, target.shape[channel_axis] - 1)
    axes = tuple(range(2, pred.ndim))
    p, t = pred.double(), target.double()
    intersection = (p * t).sum(dim=axes)
    pred_o, target_o = p.sum(dim=axes), t.sum(dim=axes)
    dice = (2.0 * intersection) / (pred_o + target_o).clamp_min(1e-12)
    if ignore_empty:
        return torch.where(target_o > 0, dice, torch.full_like(dice, float("nan")))
    empty_gt = torch.where(pred_o > 0, torch.zeros_like(dice), torch.ones_like(dice))
    return torch.where(target_o > 0, dice, empty_gt)


def _to_numpy(a: Mask) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class MeanDice:
    """Accumulating mean Dice (NaN-aware), the ignite handler's analogue.

    ``ignore_empty=False`` by default, as the bundles' metric config has it
    (MONAI's DiceMetric scores channels empty in both as 1.0).
    """

    def __init__(self, include_background: bool = True, ignore_empty: bool = False) -> None:
        self.include_background = include_background
        self.ignore_empty = ignore_empty
        self.reset()

    def reset(self) -> None:
        self._scores: list[np.ndarray] = []

    def update(self, pred: Mask, target: Mask) -> None:
        d = dice_metric(pred, target, include_background=self.include_background, ignore_empty=self.ignore_empty)
        self._scores.append(_to_numpy(d))

    def compute(self) -> float:
        if not self._scores:
            return float("nan")
        return float(np.nanmean(np.concatenate(self._scores, axis=0)))

    def compute_per_channel(self) -> np.ndarray:
        if not self._scores:
            return np.asarray([], dtype=np.float64)
        return np.nanmean(np.concatenate(self._scores, axis=0), axis=0)


def _surface_points(mask: np.ndarray) -> np.ndarray:
    """Boolean surface (border) voxels of a binary mask."""
    eroded = _ndi.binary_erosion(mask, iterations=1, border_value=0)
    return mask & ~eroded


def hausdorff_distance_95(
    pred: Mask,
    target: Mask,
    percentile: float = 95.0,
    spacing: Optional[tuple] = None,
) -> float:
    """Symmetric percentile Hausdorff distance between two binary masks, on the host.

    NaN if either mask is empty, as MONAI returns.  ``spacing`` (mm per voxel)
    scales the distances; its leading ``ndim`` entries are used.
    """
    if _ndi is None:
        raise ImportError("scipy is required for Hausdorff distance")
    pred = _to_numpy(pred).astype(bool)
    target = _to_numpy(target).astype(bool)
    if not pred.any() or not target.any():
        return float("nan")

    sp = _surface_points(pred)
    st = _surface_points(target)
    # Meta affines are homogeneous (often 4x4 even for 2-D rasters); keep the
    # leading ndim entries so the sampling always matches the mask rank.
    sampling = tuple(spacing)[: pred.ndim] if spacing is not None else (1.0,) * pred.ndim
    if len(sampling) != pred.ndim:
        raise ValueError(f"spacing has {len(sampling)} entries for a {pred.ndim}-D mask")

    # Distance from each surface to the other mask's surface.
    dt_t = _ndi.distance_transform_edt(~st, sampling=sampling)
    dt_p = _ndi.distance_transform_edt(~sp, sampling=sampling)
    return float(max(np.percentile(dt_t[sp], percentile), np.percentile(dt_p[st], percentile)))


class MeanHausdorffDistance:
    """Accumulating mean HD95 over samples and channels (NaN-aware)."""

    def __init__(self, percentile: float = 95.0, include_background: bool = True) -> None:
        self.percentile = percentile
        self.include_background = include_background
        self.reset()

    def reset(self) -> None:
        self._scores: list[float] = []

    def update(self, pred: Mask, target: Mask, spacing: Optional[tuple] = None) -> None:
        """Accumulate HD95 per sample and channel of ``(B, C, *S)`` masks.

        ``spacing`` is the voxel spacing of the grid the masks lie on, so the
        distances are in mm rather than voxels, as MONAI's
        HausdorffDistanceMetric gives them with calibrated meta.
        """
        pred, target = _to_numpy(pred), _to_numpy(target)
        c0 = 0 if self.include_background else 1
        for b in range(pred.shape[0]):
            for c in range(c0, pred.shape[1]):
                self._scores.append(hausdorff_distance_95(pred[b, c], target[b, c], self.percentile, spacing=spacing))

    def compute(self) -> float:
        if not self._scores:
            return float("nan")
        arr = np.asarray(self._scores, dtype=np.float64)
        if not np.isfinite(arr).any():  # all masks empty: HD undefined
            return float("nan")
        return float(np.nanmean(arr))
