"""Validation image panels and per-case metric reports.

PyTorch counterpart of ``factorizer_tpu/train/observability.py``, the same
numpy code; the writer is ``torch.utils.tensorboard``'s ``SummaryWriter``.
Format-parity helpers for two observability features of the reference
bundles:

* :func:`log_validation_images` — the ``TensorBoardImageHandler`` analogue
  (reference: model_zoo/factorizer_brats23/configs/train.yaml:296-300):
  writes a center-slice panel of image / label / prediction per validation
  round (``frame_dim=-1``: slice along the last spatial axis).
* :func:`write_metrics_reports` — the ``MetricsSaver`` analogue
  (reference: evaluate.yaml:49-54 -> monai.handlers.utils
  .write_metrics_reports): ``<metric>_raw.csv`` with one row per case and
  one column per class, and ``<metric>_summary.csv`` with
  mean/median/max/min/90percentile/std per class.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np

__all__ = ["log_validation_images", "write_metrics_reports"]


def _center_slice(vol: np.ndarray) -> np.ndarray:
    """(C, *S) -> (C, H, W): center slice along the LAST spatial axis."""
    vol = np.asarray(vol)
    while vol.ndim > 3:  # slice trailing spatial axes down to (C, H, W)
        vol = vol[..., vol.shape[-1] // 2]
    if vol.ndim == 2:
        vol = vol[None]
    return vol


def _to_panel(img: np.ndarray) -> np.ndarray:
    """Normalize a (C, H, W) slice to a single (1, H, C*W) grayscale panel."""
    img = _center_slice(img).astype(np.float32)
    lo, hi = float(img.min()), float(img.max())
    if hi > lo:
        img = (img - lo) / (hi - lo)
    return np.concatenate(list(img), axis=-1)[None]  # channels side by side


def log_validation_images(
    writer,
    images: np.ndarray,
    labels: np.ndarray,
    preds: np.ndarray,
    step: int,
    tag: str = "val",
    max_samples: int = 1,
) -> None:
    """Write image/label/pred center-slice panels for the first samples.

    Args:
        writer: a ``torch.utils.tensorboard.SummaryWriter`` (or ``None``: no-op).
        images/labels/preds: ``(B, C, *S)`` arrays.
        step: global step / epoch index.
    """
    if writer is None:
        return
    n = min(max_samples, len(images))
    for b in range(n):
        suffix = f"_{b}" if n > 1 else ""
        writer.add_image(f"{tag}/image{suffix}", _to_panel(images[b]), step)
        writer.add_image(f"{tag}/label{suffix}", _to_panel(labels[b]), step)
        writer.add_image(f"{tag}/pred{suffix}", _to_panel(preds[b]), step)
    writer.flush()


_SUMMARY_OPS = {
    "mean": np.nanmean,
    "median": np.nanmedian,
    "max": np.nanmax,
    "min": np.nanmin,
    "90percentile": lambda v: np.nanpercentile(v, 90),
    "std": np.nanstd,
}


def write_metrics_reports(
    save_dir: str | Path,
    case_ids: Sequence[str],
    metric_details: Mapping[str, np.ndarray],
    summary: Optional[Mapping[str, float]] = None,
    delimiter: str = ",",
) -> list[str]:
    """MetricsSaver-style CSV reports.

    Args:
        save_dir: output directory (created).
        case_ids: one id/filename per case (row labels of the raw CSVs).
        metric_details: metric name -> ``(n_cases, n_classes)`` array.
        summary: optional scalar metrics written to ``metrics.csv``.

    Returns:
        The list of files written.
    """
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    written: list[str] = []

    if summary:
        p = save_dir / "metrics.csv"
        with open(p, "w") as f:
            for k, v in summary.items():
                f.write(f"{k}{delimiter}{v}\n")
        written.append(str(p))

    for name, values in metric_details.items():
        values = np.atleast_2d(np.asarray(values, dtype=np.float64))
        n_cls = values.shape[1]
        header = ["filename"] + [f"class{c}" for c in range(n_cls)] + ["mean"]

        raw = save_dir / f"{name}_raw.csv"
        with open(raw, "w") as f:
            f.write(delimiter.join(header) + "\n")
            for cid, row in zip(case_ids, values):
                with np.errstate(all="ignore"):
                    row_mean = np.nanmean(row) if np.isfinite(row).any() else np.nan
                cells = [str(cid)] + [f"{v:.4f}" for v in row] + [f"{row_mean:.4f}"]
                f.write(delimiter.join(cells) + "\n")
        written.append(str(raw))

        summ = save_dir / f"{name}_summary.csv"
        with open(summ, "w") as f:
            f.write(delimiter.join(["class"] + list(_SUMMARY_OPS)) + "\n")
            cols = [values[:, c] for c in range(n_cls)] + [values.reshape(-1)]
            names = [f"class{c}" for c in range(n_cls)] + ["mean"]
            for cname, col in zip(names, cols):
                with np.errstate(all="ignore"):
                    if np.isfinite(col).any():
                        cells = [f"{op(col):.4f}" for op in _SUMMARY_OPS.values()]
                    else:
                        cells = ["nan"] * len(_SUMMARY_OPS)
                f.write(delimiter.join([cname] + cells) + "\n")
        written.append(str(summ))

    return written
