"""Segmentation losses.

PyTorch counterpart of ``factorizer_tpu/train/losses.py``: MONAI's
``DiceCELoss`` with ``sigmoid=True, squared_pred=True``, the bundles' training
loss.  Plain functions on tensors; the loss math runs in at least float32
whatever the logits' dtype, and float64 inputs stay float64.

With ``slabs`` (a ``parallel.slabs.Slabs``) the tensors are this process's
slab of the volume, cut along the first spatial axis (slabs of equal rows or
not): Dice's per-(sample, class) sums are summed over the slabs before the
quotient, and the BCE is the slab's sum over the whole volume's voxel count
(the whole volume's rows, ``Slabs.whole_rows``), summed over the slabs.  Every
process then holds the whole volume's loss, and its backward gives the
gradient with respect to its own slab (``parallel.all_reduce_sum``).  An
empty slab (more slabs than rows) adds nothing to the sums.  A
deep-supervision head whose output every process holds whole
(``parallel.slabs.is_whole``: its level lies below the cut's grid) is taken
whole against the gathered target.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce_sum
from ..parallel.slabs import is_whole

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
    slabs=None,
) -> torch.Tensor:
    """Soft Dice loss in MONAI's formulation: the mean over batch and channels of ``1 - dice``.

    ``logits`` and ``targets`` are ``(B, C, *S)`` (``channel_axis`` selects C);
    targets are {0, 1} masks per channel.  ``slabs``: see the module.
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
    if slabs is not None:
        intersection, ground, pred = all_reduce_sum(torch.stack([intersection, ground, pred]), slabs.mesh, slabs.axis)
    dice = (2.0 * intersection + smooth_nr) / (ground + pred + smooth_dr)
    return (1.0 - dice).mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, slabs=None) -> torch.Tensor:
    """Numerically stable binary cross-entropy with logits (mean reduction; ``slabs``: see the module)."""
    dt = _loss_dtype(logits)
    logits = logits.to(dt)
    targets = targets.to(dt)
    # max(x, 0) - x*t + log(1 + exp(-|x|))
    terms = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    if slabs is None:
        return terms.mean()
    count = math.prod(terms.shape[:2]) * math.prod(terms.shape[3:]) * slabs.whole_rows(terms.shape[2])
    return all_reduce_sum(terms.sum() / count, slabs.mesh, slabs.axis)


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
    slabs=None,
) -> torch.Tensor:
    """Dice + (binary) cross-entropy, the bundles' training loss (``slabs``: see the module)."""
    d = dice_loss(
        logits,
        targets,
        sigmoid=sigmoid,
        squared_pred=squared_pred,
        include_background=include_background,
        smooth_nr=smooth_nr,
        smooth_dr=smooth_dr,
        slabs=slabs,
    )
    return lambda_dice * d + lambda_ce * bce_with_logits(logits, targets, slabs)


def deep_supervision_loss(
    logits_pyramid: Sequence[torch.Tensor],
    targets: torch.Tensor,
    weights: Optional[Sequence[float]] = None,
    slabs=None,
    **kwargs,
) -> torch.Tensor:
    """Weighted multi-scale loss over deep-supervision heads.

    Targets are average-pooled to each head's resolution; default weights
    halve per level and are normalised to sum to 1.  With ``slabs`` the heads
    and targets are this process's slabs: a head's slab rows divide the
    target's, so each slab pools its own rows, and each head's DiceCE sums
    over the slabs (see the module).  A head that every process holds whole
    (``parallel.slabs.is_whole``) is pooled from the gathered target and taken
    whole on every process: its value is the whole term, and the head's
    output, which counts its gradient once over the slabs, carries it back.
    """
    n = len(logits_pyramid)
    if weights is None:
        weights = [0.5**j for j in range(n)]
    pool = {4: F.avg_pool2d, 5: F.avg_pool3d}

    total, gathered = 0.0, None
    for w, logits in zip(weights, logits_pyramid):
        whole = slabs is not None and is_whole(logits)
        if whole and gathered is None:
            gathered = slabs.gather_slabs(targets, dim=2)
        t = gathered if whole else targets
        if logits.shape != t.shape:
            if logits.shape[2] == 0:  # an empty slab's head: no row of the target either
                t = t.new_zeros(logits.shape, dtype=_loss_dtype(t))
            else:
                factors = tuple(ts // ls for ts, ls in zip(t.shape[2:], logits.shape[2:]))
                if slabs is not None and not whole and t.shape[2] != factors[0] * logits.shape[2]:
                    raise ValueError(f"deep_supervision_loss on slabs: a head of {logits.shape[2]} rows a slab does "
                                     f"not pool from a target of {t.shape[2]}")
                t = pool[t.ndim](t.to(_loss_dtype(t)), factors)
        total = total + w * dice_ce_loss(logits, t, slabs=None if whole else slabs, **kwargs)
    return total / sum(weights)
