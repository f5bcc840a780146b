"""The bundles' programs: their networks, evaluation and k-fold ensemble inference.

The networks of five bundles (``factorizer_brats23``, ``factorizer_isles22``, ``deconver_brats23``,
``deconver_isles22``, ``deconver_fives``), their optimiser settings and k-fold ensemble prediction.
The two Factorizer factories pass ``rank`` and ``factorize_options`` through, as the bundles'
``--network_def#...`` overrides do: rank above 1 and ``{"use_windowed": False}`` take the flat-NMF route.

PyTorch counterpart of ``factorizer_tpu/zoo_scripts.py``, the L4 glue that the
bundles' ``evaluate.yaml`` and ``inference.yaml`` call (reference
evaluate.yaml:11-54, inference.yaml:107-161): checkpoint restore
(:func:`load_model_checkpoint`), sliding-window prediction, the round trip
through the inverted preprocessing, NIfTI export, per-case metrics
(:func:`evaluate_bundle`), and the mean of k fold models' sigmoids with the
BraTS label fusion (:func:`ensemble_inference`).  ``inference_aot.yaml``'s
``aot_compile: true`` replays one CUDA graph of the window forward instead of
the eager forward, the counterpart of the JAX package's AOT-compiled
executable.  ``brats23_transforms`` builds the ``factorizer_brats23`` bundle's
preprocessing from ``data.transforms`` without the config parser.
"""

from __future__ import annotations

import copy
import json
import logging
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .data import load_decathlon_datalist
from .data import transforms as T
from .layers.basic import InstanceNorm
from .models.deconver import Deconver
from .models.factorizer import Factorizer
from .ops.reshape import SWMatricize
from .train.checkpoint import CheckpointManager, restore_checkpoint
from .train.loop import Evaluator, _first
from .train.metrics import dice_metric, hausdorff_distance_95, voxel_spacing_from_meta
from .train.observability import write_metrics_reports
from .train.sliding_window import sliding_window_inference
from .utils.helpers import materialize, resolve_device
from .utils.profiling import span
from .utils.weights import flax_state_dict

logger = logging.getLogger("factorizer_tpu_torch")

__all__ = ["brats23_network", "brats23_optimizer_settings", "brats23_transforms", "factorizer_isles22_network", "deconver_brats23_network",
           "deconver_isles22_network", "deconver_fives_network", "ensemble_predict", "evaluate_bundle", "ensemble_inference",
           "fuse_brats_labels", "load_model_checkpoint"]


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


def brats23_transforms(roi_size: Sequence[int] = (128, 128, 128),
                       pix_size: Sequence[float] = (1.0, 1.0, 1.0)) -> tuple[T.Compose, T.Compose]:
    """The bundle's ``deterministic_transforms`` and ``random_transforms`` (train.yaml:49-108), as two
    :class:`~.data.transforms.Compose`: training applies both in turn, validation the first.

    Load the four modalities and the label, one-hot the BraTS regions, crop to
    the foreground, orient to RAS, normalise the nonzero voxels per channel,
    resample to ``pix_size`` and pad up to ``roi_size``; then a random
    ``roi_size`` crop, affine, noise, smoothing, intensity scale and shift,
    and flips on each axis.  The random tail draws from fresh entropy until
    ``set_random_state`` seeds it.
    """
    keys = ["image", "label"]
    deterministic = T.Compose([
        T.LoadImaged(keys, ensure_channel_first=True),
        T.BraTSOneHotEncoderd("label"),
        T.CropForegroundd(keys, source_key="image", margin=10),
        T.Orientationd(keys, axcodes="RAS"),
        T.NormalizeIntensityd("image", nonzero=True, channel_wise=True),
        T.Spacingd(keys, pixdim=list(pix_size), mode=["bilinear", "nearest"]),
        T.EnsureTyped(keys, dtype=["float32", "uint8"]),
        T.SpatialPadd(keys, spatial_size=list(roi_size)),
    ])
    augment = T.Compose([
        T.RandSpatialCropd(keys, roi_size=list(roi_size)),
        T.RandAffined(keys, prob=0.2, rotate_range=[0.26, 0.26, 0.26], scale_range=[0.2, 0.2, 0.2],
                      mode=["bilinear", "nearest"], padding_mode="border"),
        T.RandGaussianNoised("image", prob=0.2, mean=0.0, std=0.1),
        T.RandGaussianSmoothd("image", prob=0.2, sigma_x=[0.5, 1.0], sigma_y=[0.5, 1.0], sigma_z=[0.5, 1.0]),
        T.RandScaleIntensityd("image", prob=0.2, factors=0.3),
        T.RandShiftIntensityd("image", prob=0.2, offsets=0.1),
        *(T.RandFlipd(keys, prob=0.5, spatial_axis=axis) for axis in range(3)),
    ])
    return deterministic, augment


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
    ``(B, C_out, *S)``; a deep-supervised model's logits are its first head's.
    Each ``nn.Module`` runs in evaluation mode (no dropout) and is handed back
    in the mode it came in; ``models`` may also be plain callables.  Under a
    profiler each fold's sigmoid and sum, and the mean and threshold, open the
    span ``serve.combine`` (``utils.profiling.span``).
    """
    if not models:
        raise ValueError("ensemble_predict needs at least one model")
    probs = None
    for model in models:
        materialize(model, len(roi_size))
        training = isinstance(model, torch.nn.Module) and model.training
        if training:
            model.eval()  # no dropout: the JAX package serves with train=False
        try:
            logits = sliding_window_inference(image, roi_size, lambda w, m=model: _first(m(w)),
                                              sw_batch_size=sw_batch_size, overlap=overlap)
        finally:
            if training:
                model.train()
        with span("serve.combine"):
            p = torch.sigmoid(logits)
            probs = p if probs is None else probs + p
    with span("serve.combine"):
        probs = probs / len(models)
        return (probs > 0.5).to(torch.uint8), probs


def _resolve_checkpoint_dir(ckpt_path) -> Path:
    """The checkpoint file behind ``ckpt_path``, in any layout the port or the export tool writes.

    - the trainer's ``ckpt_dir`` (a :class:`~.train.checkpoint.CheckpointManager` root): its newest
      ``step_<n>.pt``, so ``evaluate.sh --ckpt_path <train ckpt_dir>`` works on training output directly;
    - one ``.pt`` file (``save_checkpoint`` of a train state, or a ``state_dict``);
    - an ``.npz`` that ``tools/export_jax_checkpoint.py`` wrote from a JAX (orbax) checkpoint.
    """
    p = Path(ckpt_path)
    if not p.is_dir():
        if not p.is_file():
            raise FileNotFoundError(f"no checkpoint at {p}")
        return p
    manager = CheckpointManager(p, max_to_keep=None)
    step = manager.latest_step()
    if step is None:
        raise FileNotFoundError(
            f"{p} holds no step_<n>.pt: a JAX (orbax) checkpoint is read after tools/export_jax_checkpoint.py converts it")
    return manager._path(step)


def _unflatten(flat: dict) -> dict:
    """``{"params/unet/stem/conv/kernel": a, ...}`` -> nested dicts."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def load_model_checkpoint(model: torch.nn.Module, ckpt_path) -> dict[str, torch.Tensor]:
    """A checkpoint's model weights as a ``state_dict`` of host tensors, the ``variables`` that
    :class:`~.train.loop.Evaluator` takes; the optimiser state is ignored and ``model`` is not changed.

    ``ckpt_path`` is any layout :func:`_resolve_checkpoint_dir` takes.  The weights must name every entry of
    ``model.state_dict()`` with its shape.
    """
    materialize(model)
    path = _resolve_checkpoint_dir(ckpt_path)
    if path.suffix == ".npz":
        with np.load(path) as flat:
            state = flax_state_dict(model, _unflatten({k: flat[k] for k in flat.files}))
    else:
        payload = restore_checkpoint(path)
        state = payload["model"] if isinstance(payload, dict) and "model" in payload else payload
    want = model.state_dict()
    if state.keys() != want.keys():
        missing, extra = sorted(want.keys() - state.keys()), sorted(state.keys() - want.keys())
        raise ValueError(f"{path}: not this model's weights (missing {missing[:3]}, unexpected {extra[:3]})")
    for key, value in state.items():
        if value.shape != want[key].shape:
            raise ValueError(f"{path}: {key} has shape {tuple(value.shape)}, the model's is {tuple(want[key].shape)}")
    return state


def fuse_brats_labels(pred: np.ndarray) -> np.ndarray:
    """Nested-region channels (ET, TC, WT) -> BraTS label map.

    WT -> 2 (edema), TC -> 1 (NCR/NET), ET -> 3; later writes overwrite
    earlier ones on the nested masks (reference: inference.yaml:123-125).
    """
    et, tc, wt = pred[0] > 0, pred[1] > 0, pred[2] > 0
    out = np.zeros(pred.shape[1:], np.uint8)
    out[wt] = 2
    out[tc] = 1
    out[et] = 3
    return out


def _uncollate(batch: dict, i: int) -> dict:
    return {k: v[i] if isinstance(v, (list, np.ndarray)) else v for k, v in batch.items()}


def evaluate_bundle(
    model: torch.nn.Module,
    ckpt_path,
    val_loader,
    roi_size: Sequence[int],
    output_dir: Optional[str] = None,
    case_metrics_path: Optional[str] = None,
    sw_batch_size: int = 2,
    overlap: float = 0.5,
    compute_hd95: bool = True,
    channel_names: Optional[Sequence[str]] = None,
    device=None,
) -> dict:
    """Checkpointed sliding-window evaluation with per-case metrics and NIfTI export.

    Per case of ``val_loader`` (batch 1): the mask ``logits > 0``, Dice per channel and, with
    ``compute_hd95``, HD95 in mm with the spacing of the case's meta.  ``output_dir`` receives each prediction
    inverted to the native grid (``Invertd``) as ``<case id>.nii.gz``; ``case_metrics_path`` the per-case JSON,
    and the ``metrics/`` CSVs beside it.  ``channel_names`` label the channels (BraTS ``["et", "tc", "wt"]``), giving
    ``dice_<name>`` means.  Runs on the card unless ``device`` names another one.  Prints the metrics as one JSON line
    and returns them.
    """
    variables = load_model_checkpoint(materialize(model, len(roi_size)), ckpt_path)
    evaluator = Evaluator(model, variables, roi_size, sw_batch_size, overlap, compute_hd95=False, device=device)

    cases, dices, hds = [], [], []
    for batch in val_loader:
        preds = evaluator.predict_mask(batch["image"])
        labels = np.asarray(batch["label"])

        d = np.asarray(dice_metric(preds, labels))
        dices.append(d)
        case = {"dice": [float(v) for v in np.nanmean(d, axis=0)]}
        if compute_hd95:
            # HD95 in mm: the meta affine tracks the evaluation grid (1 mm after Spacingd).
            metas = batch.get("image_meta")
            spacing = voxel_spacing_from_meta(metas[0]) if metas else None
            hd = [hausdorff_distance_95(preds[0, c], labels[0, c], spacing=spacing) for c in range(preds.shape[1])]
            hds.append(hd)
            case["hd95"] = hd
        ids = batch.get("id")
        if ids:
            case["id"] = ids[0]
        cases.append(case)

        if output_dir is not None:
            sample = _uncollate(batch, 0)
            sample["pred"] = preds[0]
            inverted = T.Invertd(["pred"], orig_keys="image")(sample)
            if ids:  # name outputs by case id (filename bases may collide)
                inverted.setdefault("pred_meta", {})["filename"] = f"{ids[0]}.nii.gz"
            T.SaveImaged(["pred"], output_dir=output_dir)(inverted)

    metrics = {"mean_dice": float(np.nanmean(np.concatenate(dices, axis=0))) if dices else float("nan")}
    if channel_names and dices:
        per_channel = np.nanmean(np.concatenate(dices, axis=0), axis=0)
        for name, value in zip(channel_names, per_channel):
            metrics[f"dice_{name}"] = float(value)
    if hds:
        hd_arr = np.asarray(hds, dtype=np.float64)
        # Undefined, not a warning, where every mask is empty.
        metrics["hd95"] = float(np.nanmean(hd_arr)) if np.isfinite(hd_arr).any() else float("nan")
    if case_metrics_path:
        Path(case_metrics_path).parent.mkdir(parents=True, exist_ok=True)
        Path(case_metrics_path).write_text(json.dumps({"cases": cases, **metrics}, indent=2))
        # MetricsSaver-style CSVs beside the JSON (reference evaluate.yaml:49-54).
        details = {"mean_dice": np.concatenate(dices, axis=0)} if dices else {}
        if hds:
            details["hd95"] = np.asarray(hds, dtype=np.float64)
        case_ids = [c.get("id", f"case{i}") for i, c in enumerate(cases)]
        write_metrics_reports(Path(case_metrics_path).parent / "metrics", case_ids, details, metrics)
    logger.info("evaluation: %s", metrics)
    print(json.dumps(metrics))
    return metrics


class _GraphedForward:
    """One CUDA graph of ``net``'s forward on a fixed window batch, replayed for every call.

    ``net``'s parameters and buffers are the graph's static weights: loading another fold's ``state_dict`` into
    ``net`` copies into them, so one graph serves every fold.  Built at the first call, from its shape and dtype:
    two forwards on a side stream first (cuDNN's algorithm choice, the caching allocator), then the capture.  A call
    copies its windows into the static input, replays, and returns the static output, which the next call overwrites.
    """

    WARMUP = 2

    def __init__(self, net: torch.nn.Module) -> None:
        self.net = net
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def _capture(self, windows: torch.Tensor) -> None:
        self.static_in = torch.zeros_like(windows)
        main = torch.cuda.current_stream(windows.device)
        side = torch.cuda.Stream(windows.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                self.net(self.static_in)
        main.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.static_out = _first(self.net(self.static_in))
        ensemble_inference.graph_captures += 1

    def __call__(self, windows: torch.Tensor) -> torch.Tensor:
        if self.graph is None:
            self._capture(windows)
        elif windows.shape != self.static_in.shape or windows.dtype != self.static_in.dtype:
            raise ValueError(f"the graph was captured for windows {tuple(self.static_in.shape)} {self.static_in.dtype}, "
                             f"got {tuple(windows.shape)} {windows.dtype}")
        self.static_in.copy_(windows)
        self.graph.replay()
        ensemble_inference.graph_replays += 1
        return self.static_out


def _inference_preprocessing(roi_size: Sequence[int], pix_size: Sequence[float]) -> T.Compose:
    """The image preprocessing of ``inference.yaml``: load, (3-D) foreground crop and RAS, per-channel
    normalisation of the nonzero voxels, (3-D) resampling to ``pix_size``, padding up to ``roi_size``."""
    spatial_dims = len(roi_size)
    pre = [T.LoadImaged(["image"], ensure_channel_first=True)]
    if spatial_dims == 3:
        pre += [T.CropForegroundd(["image"], source_key="image", margin=10), T.Orientationd(["image"], axcodes="RAS")]
    pre += [T.NormalizeIntensityd(["image"], nonzero=True, channel_wise=True)]
    if spatial_dims == 3:
        pre += [T.Spacingd(["image"], pixdim=pix_size, mode="bilinear")]
    pre += [T.SpatialPadd(["image"], spatial_size=roi_size)]
    return T.Compose(pre)


def ensemble_inference(
    model: torch.nn.Module,
    ckpt_paths: Sequence[str],
    datalist_path: str,
    data_dir: str,
    roi_size: Sequence[int],
    pix_size: Sequence[float],
    output_dir: str,
    dataset: str = "",
    section: str = "test",
    sw_batch_size: int = 2,
    overlap: float = 0.5,
    aot_compile: bool = False,
    device=None,
) -> list[str]:
    """k-fold mean-ensemble inference over a datalist section, saving NIfTI predictions; returns their paths.

    Per case: the inference preprocessing, per fold checkpoint the sliding-window logits' sigmoid, their mean
    thresholded at 0.5, ``Invertd`` back to the native grid, for ``dataset="brats23"`` the label fusion
    (:func:`fuse_brats_labels`), and ``<case id>.nii.gz`` in ``output_dir``.  ``section`` falls back to
    ``"training"`` where the datalist has none.  ``model`` is copied once; each fold's weights are loaded into the
    copy.  ``aot_compile`` replays one CUDA graph of the copy's forward on ``(sw_batch_size, C_in, *roi_size)``
    windows for every window group and fold (the sliding window keeps every call at that shape), counted in
    ``ensemble_inference.graph_captures`` and ``.graph_replays``; a CUDA graph needs the card, so with ``device``
    on the CPU it raises.  Runs on the card unless ``device`` names another one.
    """
    if not ckpt_paths:
        raise ValueError("No checkpoints found for ensembling.")
    device = resolve_device(device)
    if aot_compile and device.type != "cuda":
        raise ValueError(f"aot_compile=True replays a CUDA graph, which needs the card; the device is {device}")
    materialize(model, len(roi_size))
    folds = [{k: v.to(device) for k, v in load_model_checkpoint(model, p).items()} for p in ckpt_paths]
    preprocessing = _inference_preprocessing(roi_size, pix_size)
    net = copy.deepcopy(model).to(device).eval()
    predict = _GraphedForward(net) if aot_compile else (lambda windows: _first(net(windows)))

    items = load_decathlon_datalist(datalist_path, section=section, base_dir=data_dir)
    if not items:
        items = load_decathlon_datalist(datalist_path, section="training", base_dir=data_dir)
    saved = []
    for item in items:
        d = preprocessing(dict(item))
        image = torch.as_tensor(np.asarray(d["image"]))[None].to(device)
        probs = None
        for state in folds:
            net.load_state_dict(state)
            with torch.inference_mode():
                logits = sliding_window_inference(image, roi_size, predict, sw_batch_size=sw_batch_size,
                                                  overlap=overlap)
                p = torch.sigmoid(logits)
                probs = p if probs is None else probs + p
        probs = (probs / len(folds))[0].cpu().numpy()
        d["pred"] = (probs > 0.5).astype(np.uint8)
        d = T.Invertd(["pred"], orig_keys="image")(d)
        if dataset == "brats23":
            d["pred"] = fuse_brats_labels(d["pred"])[None]
        if "id" in item:  # name outputs by case id (filename bases may collide)
            d.setdefault("pred_meta", {})["filename"] = f"{item['id']}.nii.gz"
        d = T.SaveImaged(["pred"], output_dir=output_dir)(d)
        saved.append(d.get("pred_saved_path"))
        logger.info("saved %s", saved[-1])
    return saved


ensemble_inference.graph_captures = 0
ensemble_inference.graph_replays = 0
