"""The networks of five bundles (``factorizer_brats23``, ``factorizer_isles22``, ``deconver_brats23``,
``deconver_isles22``, ``deconver_fives``), their optimiser settings and k-fold ensemble prediction.

The two Factorizer factories pass ``rank`` and ``factorize_options`` through, as the bundles'
``--network_def#...`` overrides do: rank above 1 and ``{"use_windowed": False}`` take the flat-NMF route.

PyTorch counterpart of the model half of ``ensemble_inference`` in
``factorizer_tpu/zoo_scripts.py``: sliding-window logits per fold model, the
mean of their sigmoids, and a threshold at 0.5.  NIfTI IO, the preprocessing
transforms and the ``SegmentationTrainer`` workflow are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .layers.basic import InstanceNorm
from .models.deconver import Deconver
from .models.factorizer import Factorizer
from .ops.reshape import SWMatricize
from .train.sliding_window import sliding_window_inference
from .utils.helpers import resolve_device

__all__ = ["brats23_network", "brats23_optimizer_settings", "factorizer_isles22_network", "deconver_brats23_network",
           "deconver_isles22_network", "deconver_fives_network", "ensemble_predict"]


def _factorizer_bundle(in_channels, out_channels, roi, patch_size, shifts, rank, factorize_options, remat, dtype,
                       device, generator) -> Factorizer:
    """What the two Factorizer bundles share: five stages of one block each, head_dim 8, five HALS iterations."""
    return Factorizer(
        in_channels=in_channels,
        out_channels=out_channels,
        spatial_size=roi,
        encoder_depth=(1, 1, 1, 1, 1),
        encoder_width=(32, 64, 128, 256, 512),
        strides=(1, 2, 2, 2, 2),
        decoder_depth=(1, 1, 1, 1),
        mlp_ratio=4,
        reshape=(SWMatricize, {"head_dim": 8, "patch_size": patch_size, "shifts": shifts}),
        act="relu",
        rank=rank,
        num_iters=5,
        num_grad_steps=None,
        init_method="uniform",
        solver="hals",
        factorize_options=factorize_options,
        remat=remat,
        dtype=dtype,
        device=resolve_device(device),
        generator=generator,
    )


def brats23_network(
    dtype: Optional[torch.dtype] = None,
    device=None,
    generator: Optional[torch.Generator] = None,
    rank: int = 1,
    factorize_options: Optional[dict] = None,
    remat: bool = False,
) -> Factorizer:
    """The bundle's ``network_def`` (zoo/factorizer_brats23/configs/train.yaml:24-48).

    ``dtype=torch.bfloat16`` is the bundle's ``amp: true``; None (f32) is
    what it ships.  Weights are random, drawn from ``generator``.  The network
    is built on the card unless ``device`` names another one (``"cpu"``).
    ``rank``, ``factorize_options`` and ``remat`` are the bundle's overrides: the
    default runs the windowed route (K1), ``rank`` above 1 or
    ``{"use_windowed": False}`` the flat route (K4); ``remat=True`` recomputes
    each stage in the backward (the bundle's ``remat: true``).
    """
    return _factorizer_bundle(4, 3, (128, 128, 128), 8, [None, 2, 4, 6], rank, factorize_options, remat, dtype, device,
                              generator)


def factorizer_isles22_network(
    dtype: Optional[torch.dtype] = None,
    device=None,
    generator: Optional[torch.Generator] = None,
    rank: int = 1,
    factorize_options: Optional[dict] = None,
    remat: bool = False,
) -> Factorizer:
    """The ``factorizer_isles22`` bundle's ``network_def`` (zoo/factorizer_isles22/configs/train.yaml:24-48):
    DWI and ADC in, one lesion mask out, roi 64^3, batch 8, patches of 4^3 at shifts 0, 1, 2, 3.

    Arguments as in :func:`brats23_network`.
    """
    return _factorizer_bundle(2, 1, (64, 64, 64), 4, [None, 1, 2, 3], rank, factorize_options, remat, dtype, device,
                              generator)


def _deconver_bundle(in_channels, out_channels, kernel_size, remat, dtype, device, generator) -> Deconver:
    """What the two Deconver bundles share: five stages of one depthwise block each, ``InstanceNorm``, one update."""
    return Deconver(
        in_channels=in_channels,
        out_channels=out_channels,
        spatial_dims=len(kernel_size),
        encoder_depth=(1, 1, 1, 1, 1),
        encoder_width=(32, 64, 128, 256, 512),
        strides=(1, 2, 2, 2, 2),
        decoder_depth=(1, 1, 1, 1),
        norm=InstanceNorm,
        act="relu",
        groups=-1,
        ratio=1,
        kernel_size=kernel_size,
        num_iters=1,
        num_grad_iters=None,
        mlp_ratio=4,
        remat=remat,
        dtype=dtype,
        device=resolve_device(device),
        generator=generator,
    )


def deconver_brats23_network(
    dtype: Optional[torch.dtype] = None,
    device=None,
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
) -> Deconver:
    """The ``deconver_brats23`` bundle's ``network_def`` (zoo/deconver_brats23/configs/train.yaml:24-42):
    4 modalities in, 3 regions out, 3-D, kernel 3x3x3, roi 128^3, batch 2.

    ``dtype``, ``device``, ``generator`` and ``remat`` as in
    :func:`brats23_network`: the card unless ``device`` names another one.
    """
    return _deconver_bundle(4, 3, (3, 3, 3), remat, dtype, device, generator)


def deconver_isles22_network(
    dtype: Optional[torch.dtype] = None,
    device=None,
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
) -> Deconver:
    """The ``deconver_isles22`` bundle's ``network_def`` (zoo/deconver_isles22/configs/train.yaml:24-42):
    2 modalities in, one lesion mask out, 3-D, kernel 3x3x3, roi 64^3, batch 8."""
    return _deconver_bundle(2, 1, (3, 3, 3), remat, dtype, device, generator)


def deconver_fives_network(
    dtype: Optional[torch.dtype] = None,
    device=None,
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
) -> Deconver:
    """The ``deconver_fives`` bundle's ``network_def`` (zoo/deconver_fives/configs/train.yaml:24-42):
    RGB in, one vessel mask out, 2-D, kernel 7x7, roi 512^2, batch 16."""
    return _deconver_bundle(3, 1, (7, 7), remat, dtype, device, generator)


def brats23_optimizer_settings(steps_per_epoch: int) -> dict:
    """The bundle's AdamW and warm-up-cosine numbers (train.yaml:10-14), as ``create_train_state`` takes them;
    the two Deconver bundles ship the same numbers.

    Mirrors ``SegmentationTrainer`` (``factorizer_tpu/train/loop.py:124-130``):
    lr 1e-4, weight decay 1e-5, 5 warm-up epochs of 500.
    """
    steps = max(steps_per_epoch, 1)
    return {"lr": 1e-4, "weight_decay": 1e-5, "warmup_steps": 5 * steps, "total_steps": 500 * steps}


@torch.inference_mode()
def ensemble_predict(
    models: Sequence[torch.nn.Module],
    image: torch.Tensor,
    roi_size: Sequence[int],
    sw_batch_size: int = 2,
    overlap: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean-ensemble sliding-window prediction of ``image (B, C, *S)``.

    Returns ``(mask, probs)``: the uint8 mask ``probs > 0.5`` and the mean over
    ``models`` of the sigmoid of each model's blended logits, both
    ``(B, C_out, *S)``.
    """
    if not models:
        raise ValueError("ensemble_predict needs at least one model")
    probs = None
    for model in models:
        logits = sliding_window_inference(image, roi_size, model, sw_batch_size=sw_batch_size, overlap=overlap)
        p = torch.sigmoid(logits)
        probs = p if probs is None else probs + p
    probs = probs / len(models)
    return (probs > 0.5).to(torch.uint8), probs
