"""Segmentation losses.

PyTorch counterpart of ``factorizer_tpu/train/losses.py``: MONAI's
``DiceCELoss`` with ``sigmoid=True, squared_pred=True``, the bundles' training
loss.  Plain functions on tensors; the loss math runs in at least float32
whatever the logits' dtype, and float64 inputs stay float64.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["dice_loss", "bce_with_logits", "dice_ce_loss", "deep_supervision_loss"]


def _loss_dtype(logits: torch.Tensor) -> torch.dtype:
    # Reducing bf16 probabilities over 128^3 voxels loses the sum in the 8-bit
    # mantissa, so bf16 logits (amp) are lifted to f32 first.
    return torch.promote_types(logits.dtype, torch.float32)


def dice_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    sigmoid: bool = True,
    squared_pred: bool = True,
    include_background: bool = True,
    smooth_nr: float = 1e-5,
    smooth_dr: float = 1e-5,
    channel_axis: int = 1,
) -> torch.Tensor:
    """Soft Dice loss in MONAI's formulation: the mean over batch and channels of ``1 - dice``.

    ``logits`` and ``targets`` are ``(B, C, *S)`` (``channel_axis`` selects C);
    targets are {0, 1} masks per channel.
    """
    dt = _loss_dtype(logits)
    probs = logits.to(dt)
    targets = targets.to(dt)
    if sigmoid:
        probs = torch.sigmoid(probs)
    if not include_background:
        probs = probs.narrow(channel_axis, 1, probs.shape[channel_axis] - 1)
        targets = targets.narrow(channel_axis, 1, targets.shape[channel_axis] - 1)

    reduce_axes = [i for i in range(probs.ndim) if i not in (0, channel_axis % probs.ndim)]
    intersection = (targets * probs).sum(reduce_axes)
    if squared_pred:
        ground, pred = (targets**2).sum(reduce_axes), (probs**2).sum(reduce_axes)
    else:
        ground, pred = targets.sum(reduce_axes), probs.sum(reduce_axes)
    dice = (2.0 * intersection + smooth_nr) / (ground + pred + smooth_dr)
    return (1.0 - dice).mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross-entropy with logits (mean reduction)."""
    dt = _loss_dtype(logits)
    logits = logits.to(dt)
    targets = targets.to(dt)
    # max(x, 0) - x*t + log(1 + exp(-|x|))
    return (logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))).mean()


def dice_ce_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    sigmoid: bool = True,
    squared_pred: bool = True,
    include_background: bool = True,
    lambda_dice: float = 1.0,
    lambda_ce: float = 1.0,
    smooth_nr: float = 1e-5,
    smooth_dr: float = 1e-5,
) -> torch.Tensor:
    """Dice + (binary) cross-entropy, the bundles' training loss."""
    d = dice_loss(
        logits,
        targets,
        sigmoid=sigmoid,
        squared_pred=squared_pred,
        include_background=include_background,
        smooth_nr=smooth_nr,
        smooth_dr=smooth_dr,
    )
    return lambda_dice * d + lambda_ce * bce_with_logits(logits, targets)


def deep_supervision_loss(
    logits_pyramid: Sequence[torch.Tensor],
    targets: torch.Tensor,
    weights: Optional[Sequence[float]] = None,
    **kwargs,
) -> torch.Tensor:
    """Weighted multi-scale loss over deep-supervision heads.

    Targets are average-pooled to each head's resolution; default weights
    halve per level and are normalised to sum to 1.
    """
    n = len(logits_pyramid)
    if weights is None:
        weights = [0.5**j for j in range(n)]
    pool = {4: F.avg_pool2d, 5: F.avg_pool3d}

    total = 0.0
    for w, logits in zip(weights, logits_pyramid):
        t = targets
        if logits.shape != targets.shape:
            factors = tuple(ts // ls for ts, ls in zip(targets.shape[2:], logits.shape[2:]))
            t = pool[targets.ndim](targets.to(_loss_dtype(targets)), factors)
        total = total + w * dice_ce_loss(logits, t, **kwargs)
    return total / sum(weights)
