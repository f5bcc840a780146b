"""Bundle serving: the ``factorizer_brats23`` network and k-fold ensemble prediction.

PyTorch counterpart of the model half of ``ensemble_inference`` in
``factorizer_tpu/zoo_scripts.py``: sliding-window logits per fold model, the
mean of their sigmoids, and a threshold at 0.5.  NIfTI IO and the
preprocessing transforms are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .models.factorizer import Factorizer
from .ops.reshape import SWMatricize
from .train.sliding_window import sliding_window_inference

__all__ = ["brats23_network", "ensemble_predict"]


def brats23_network(
    dtype: Optional[torch.dtype] = None,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> Factorizer:
    """The bundle's ``network_def`` (zoo/factorizer_brats23/configs/train.yaml:24-48).

    ``dtype=torch.bfloat16`` is the bundle's ``amp: true``; None (f32) is
    what it ships.  Weights are random, drawn from ``generator``.
    """
    return Factorizer(
        in_channels=4,
        out_channels=3,
        spatial_size=(128, 128, 128),
        encoder_depth=(1, 1, 1, 1, 1),
        encoder_width=(32, 64, 128, 256, 512),
        strides=(1, 2, 2, 2, 2),
        decoder_depth=(1, 1, 1, 1),
        mlp_ratio=4,
        reshape=(SWMatricize, {"head_dim": 8, "patch_size": 8, "shifts": [None, 2, 4, 6]}),
        act="relu",
        rank=1,
        num_iters=5,
        num_grad_steps=None,
        init_method="uniform",
        solver="hals",
        dtype=dtype,
        device=device,
        generator=generator,
    )


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
