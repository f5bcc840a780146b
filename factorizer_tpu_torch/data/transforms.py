"""Dictionary-based preprocessing / augmentation transforms (host-side numpy).

The workflow layer's replacement for the MONAI transform pipeline used by the
bundles (reference: model_zoo/factorizer_brats23/configs/train.yaml:84-162).
Each transform maps a ``dict`` of arrays (plus ``<key>_meta`` geometry dicts)
to a new dict; invertible geometry transforms push a record onto
``<key>_transforms`` so :class:`Invertd` can restore predictions to native
geometry (the ``Invertd`` round trip of evaluate.yaml:11-18).

All compute is numpy/scipy on the host — augmentation runs in data-loader
worker threads while the card trains (the DataLoader-workers analogue).
"""

from __future__ import annotations

import math
import os
import threading
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

try:
    from scipy import ndimage as ndi
except ImportError:  # pragma: no cover
    ndi = None

from .nifti import load_nifti, save_nifti

__all__ = [
    "Compose",
    "MapTransform",
    "RandomizableTransform",
    "LoadImaged",
    "EnsureChannelFirstd",
    "BraTSOneHotEncoderd",
    "CropForegroundd",
    "Orientationd",
    "NormalizeIntensityd",
    "Spacingd",
    "EnsureTyped",
    "SpatialPadd",
    "CenterSpatialCropd",
    "RandSpatialCropd",
    "RandCropByPosNegLabeld",
    "RandAffined",
    "RandGaussianNoised",
    "RandGaussianSmoothd",
    "RandScaleIntensityd",
    "RandShiftIntensityd",
    "RandFlipd",
    "ScaleIntensityRanged",
    "Activationsd",
    "AsDiscreted",
    "SplitDimd",
    "Lambdad",
    "Invertd",
    "SaveImaged",
    "ToTensord",
]


def _as_seq(x, n):
    if isinstance(x, (list, tuple)):
        return list(x) if len(x) > 1 else list(x) * n
    return [x] * n


class Transform:
    def __call__(self, data: dict) -> dict:
        raise NotImplementedError


class Compose(Transform):
    def __init__(self, transforms: Sequence[Callable]) -> None:
        self.transforms = list(transforms)

    def __call__(self, data: dict) -> dict | list[dict]:
        # A transform may emit a list of samples (e.g. RandCropByPosNegLabeld
        # with num_samples > 1); subsequent transforms map over each sample,
        # mirroring MONAI's apply_transform semantics.
        for t in self.transforms:
            if isinstance(data, list):
                out: list[dict] = []
                for item in data:
                    res = t(item)
                    out.extend(res) if isinstance(res, list) else out.append(res)
                data = out
            else:
                data = t(data)
        return data

    def set_random_state(self, seed: int) -> "Compose":
        for i, t in enumerate(self.transforms):
            if isinstance(t, RandomizableTransform):
                t.set_random_state(seed + i)
        return self


class MapTransform(Transform):
    def __init__(self, keys: str | Sequence[str], allow_missing_keys: bool = False) -> None:
        self.keys = [keys] if isinstance(keys, str) else list(keys)
        self.allow_missing_keys = allow_missing_keys

    def key_iterator(self, data: Mapping):
        for k in self.keys:
            if k in data:
                yield k
            elif not self.allow_missing_keys:
                raise KeyError(f"Key {k!r} missing and allow_missing_keys=False.")


class RandomizableTransform(MapTransform):
    """Random transform with thread-safe RNG.

    numpy ``Generator`` objects are not thread-safe, and the DataLoader maps
    ``Dataset.__getitem__`` over a thread pool — so each worker thread draws
    from its own child stream spawned from a shared ``SeedSequence``.
    """

    def __init__(self, keys, prob: float = 1.0, allow_missing_keys: bool = False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.prob = prob
        self._rng_epoch = 0
        self._spawn_lock = threading.Lock()
        self._local = threading.local()
        self._seed_seq = np.random.SeedSequence()

    def set_random_state(self, seed: int) -> None:
        with self._spawn_lock:
            self._seed_seq = np.random.SeedSequence(seed)
            self._rng_epoch += 1  # invalidate every thread's cached generator

    @property
    def rng(self) -> np.random.Generator:
        local = self._local
        from .dataset import get_worker_epoch, get_worker_id

        wid = get_worker_id()
        # the loader epoch is part of the stream identity: under
        # persistent_workers the SAME process serves several epochs, so the
        # cached generator must be re-derived when the epoch advances
        loader_epoch = get_worker_epoch() if wid is not None else None
        if (
            getattr(local, "epoch", None) != self._rng_epoch
            or getattr(local, "wid", -1) != wid
            or getattr(local, "loader_epoch", -1) != loader_epoch
        ):
            with self._spawn_lock:
                if wid is None:
                    child = self._seed_seq.spawn(1)[0]
                else:
                    # forked pool worker: fork copied the parent's spawn
                    # counter into every worker, so spawn() would hand all
                    # workers the SAME stream; derive a distinct
                    # deterministic one from (worker id, loader epoch)
                    # instead — without the epoch, each epoch's freshly
                    # forked pool would replay epoch 1's stream exactly
                    child = np.random.SeedSequence(
                        entropy=self._seed_seq.entropy,
                        spawn_key=(0x57AB, wid, get_worker_epoch()),
                    )
                local.epoch = self._rng_epoch
            local.wid = wid
            local.loader_epoch = loader_epoch
            local.rng = np.random.Generator(np.random.PCG64(child))
        return local.rng

    def _do(self) -> bool:
        return bool(self.rng.random() < self.prob)


def _push_record(data: dict, key: str, record: dict) -> None:
    data.setdefault(f"{key}_transforms", []).append(record)


def _resample_threads() -> int:
    """Native-resampler thread count: auto on the main process, 1 inside a
    forked DataLoader worker (N workers x hardware_concurrency threads would
    oversubscribe the host and undo the pool's parallelism)."""
    from .dataset import get_worker_id

    return 1 if get_worker_id() is not None else 0


# ---------------------------------------------------------------- IO


def _load_image_any(path) -> "NiftiImage":
    """Load a NIfTI volume or a 2-D raster image (PNG/JPEG/BMP).

    Raster images get an identity affine; this lets datalists that reference
    the raw FIVES PNGs (as the reference's shipped manifest does —
    reference: model_zoo/deconver_fives/configs/datalist.json) run without a
    separate conversion pass.
    """
    suffix = str(path).lower().rsplit(".", 1)[-1]
    if suffix in ("png", "jpg", "jpeg", "bmp"):
        from PIL import Image

        from .nifti import NiftiImage

        arr = np.asarray(Image.open(path))
        return NiftiImage(data=arr, affine=np.eye(4), header={"raster": True})
    return load_nifti(path)


class LoadImaged(MapTransform):
    """Load NIfTI volume(s) or 2-D raster images; a list of paths is stacked
    as channels.

    Produces ``data[key]`` with channel-first layout ``(C, *S)`` when
    ``ensure_channel_first`` and ``data[f"{key}_meta"]`` with the affine.
    """

    def __init__(
        self,
        keys,
        ensure_channel_first: bool = True,
        image_only: bool = True,
        dtype=np.float32,
        channel_dim: Optional[int] = None,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.ensure_channel_first = ensure_channel_first
        self.dtype = dtype
        self.channel_dim = channel_dim  # e.g. -1 for RGB (H, W, 3) images

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            paths = d[key]
            if isinstance(paths, (list, tuple)):
                if len(paths) > 1 and _resample_threads() != 1 and (os.cpu_count() or 1) > 1:
                    # Multi-modality case: decode the files concurrently (the
                    # native NIfTI decoder and gzip release the GIL).  Inside
                    # forked loader workers this stays serial — the pool is
                    # the parallelism there (same policy as the resampler).
                    from concurrent.futures import ThreadPoolExecutor

                    with ThreadPoolExecutor(min(len(paths), 4)) as pool:
                        imgs = list(pool.map(_load_image_any, paths))
                else:
                    imgs = [_load_image_any(p) for p in paths]
                arr = np.stack([np.asarray(im.data) for im in imgs], axis=0)
                affine = imgs[0].affine
            else:
                im = _load_image_any(paths)
                arr, affine = np.asarray(im.data), im.affine
                if self.ensure_channel_first:
                    if self.channel_dim is not None and arr.ndim >= 3:
                        arr = np.moveaxis(arr, self.channel_dim, 0)
                    elif arr.ndim == 4:  # (X, Y, Z, T) -> (T, X, Y, Z)
                        arr = np.moveaxis(arr, -1, 0)
                    else:
                        arr = arr[None]
            if self.dtype is not None:
                arr = arr.astype(self.dtype)
            d[key] = arr
            d[f"{key}_meta"] = {
                "affine": affine.copy(),
                "original_affine": affine.copy(),
                "spatial_shape": arr.shape[1:],
                "filename": paths[0] if isinstance(paths, (list, tuple)) else paths,
            }
        return d


class EnsureChannelFirstd(MapTransform):
    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            arr = np.asarray(d[key])
            if arr.ndim == 3:
                arr = arr[None]
            d[key] = arr
        return d


class ToTensord(MapTransform):
    """Terminal cast (arrays stay numpy; the trainer converts a batch to torch)."""

    def __init__(self, keys, dtype=np.float32, allow_missing_keys: bool = False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.dtype = dtype

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            d[key] = np.asarray(d[key], dtype=self.dtype)
        return d


# ---------------------------------------------------------------- labels


class BraTSOneHotEncoderd(MapTransform):
    """BraTS label map -> nested-region channels (ET, TC, WT).

    classes: 1 = NCR/NET, 2 = ED, 3 = ET
    (reference: model_zoo/factorizer_brats23/scripts/data.py:28-77)
    """

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            img = np.asarray(d[key])
            if img.ndim == 4 and img.shape[0] == 1:
                img = img[0]
            ed, ncr, et = 2, 1, 3
            d[key] = np.stack(
                [
                    img == et,
                    (img == et) | (img == ncr),
                    (img == et) | (img == ncr) | (img == ed),
                ],
                axis=0,
            ).astype(np.uint8)
        return d


# ---------------------------------------------------------------- geometry


class CropForegroundd(MapTransform):
    """Crop to the bounding box of nonzero ``source_key`` voxels + margin."""

    def __init__(self, keys, source_key: str, margin: int = 0, allow_missing_keys: bool = False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.source_key = source_key
        self.margin = margin

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        src = np.asarray(d[self.source_key])
        fg = np.any(src != 0, axis=0)
        if not fg.any():
            return d
        coords = np.nonzero(fg)
        starts, stops = [], []
        for c, size in zip(coords, fg.shape):
            starts.append(max(int(c.min()) - self.margin, 0))
            stops.append(min(int(c.max()) + 1 + self.margin, size))
        slices = tuple(slice(a, b) for a, b in zip(starts, stops))
        for key in self.key_iterator(d):
            orig_shape = d[key].shape[1:]
            d[key] = np.ascontiguousarray(d[key][(slice(None), *slices)])
            _push_record(
                d, key,
                {"op": "crop_foreground", "starts": starts, "orig_shape": orig_shape},
            )
            if f"{key}_meta" in d:
                aff = d[f"{key}_meta"]["affine"]
                aff = aff.copy()
                aff[:3, 3] += aff[:3, :3] @ np.array(starts, dtype=np.float64)
                d[f"{key}_meta"]["affine"] = aff
        return d


def _orientation_codes(affine: np.ndarray) -> list[int]:
    """For each voxel axis, the dominant world axis index (signed)."""
    R = affine[:3, :3]
    codes = []
    for j in range(3):
        i = int(np.argmax(np.abs(R[:, j])))
        sign = 1 if R[i, j] >= 0 else -1
        codes.append(sign * (i + 1))  # +-1,2,3 for R/A/S world axes
    return codes


class Orientationd(MapTransform):
    """Reorient voxel axes to the requested anatomical convention (e.g. RAS)."""

    _AX = {"R": 1, "A": 2, "S": 3, "L": -1, "P": -2, "I": -3}

    def __init__(self, keys, axcodes: str = "RAS", allow_missing_keys: bool = False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.target = [self._AX[c] for c in axcodes]

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            meta = d.get(f"{key}_meta")
            if meta is None:
                continue
            codes = _orientation_codes(meta["affine"])
            # permutation: for each target world axis, find matching voxel axis
            perm, flips = [], []
            for t in self.target:
                j = [abs(c) for c in codes].index(abs(t))
                perm.append(j)
                flips.append(codes[j] * t < 0)
            arr = np.asarray(d[key])
            arr = np.transpose(arr, (0, *[p + 1 for p in perm]))
            aff = meta["affine"]
            new_aff = np.eye(4)
            new_aff[:3, :3] = aff[:3, :3][:, perm]
            new_aff[:3, 3] = aff[:3, 3]
            for ax, f in enumerate(flips):
                if f:
                    arr = np.flip(arr, axis=ax + 1)
                    size = arr.shape[ax + 1]
                    new_aff[:3, 3] = new_aff[:3, 3] + new_aff[:3, ax] * (size - 1)
                    new_aff[:3, ax] = -new_aff[:3, ax]
            d[key] = np.ascontiguousarray(arr)
            meta["affine"] = new_aff
            _push_record(d, key, {"op": "orientation", "perm": perm, "flips": flips})
        return d


class Spacingd(MapTransform):
    """Resample to a target voxel spacing (bilinear for images, nearest for labels)."""

    def __init__(
        self,
        keys,
        pixdim: Sequence[float],
        mode: str | Sequence[str] = "bilinear",
        align_corners=None,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.pixdim = np.asarray(pixdim, dtype=np.float64)
        self.modes = _as_seq(mode, len(self.keys))

    @staticmethod
    def _resample(arr: np.ndarray, zoom: Sequence[float], order: int) -> np.ndarray:
        # ndi.zoom's (grid_mode=False) coordinate map is endpoint-aligned:
        # in = out * (in_size-1)/(out_size-1) — a diagonal affine, so the
        # native multi-channel resampler covers it (scipy fallback below).
        out_shape = tuple(int(round(s * z)) for s, z in zip(arr.shape[1:], zoom))
        if arr.ndim == 4:
            from .native import native_affine_resample

            diag = [
                (s - 1) / (o - 1) if o > 1 else 0.0
                for s, o in zip(arr.shape[1:], out_shape)
            ]
            out = native_affine_resample(
                arr.astype(np.float32, copy=False), np.diag(diag), np.zeros(3),
                order=order, mode="nearest", output_shape=out_shape,
                num_threads=_resample_threads(),
            )
            if out is not None:
                return out.astype(arr.dtype, copy=False)
        out = [ndi.zoom(c, zoom, order=order, mode="nearest", prefilter=False) for c in arr]
        return np.stack(out, axis=0)

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key, mode in zip(self.keys, self.modes):
            if key not in d:
                continue
            meta = d[f"{key}_meta"]
            spacing = np.sqrt((meta["affine"][:3, :3] ** 2).sum(axis=0))
            zoom = spacing / self.pixdim
            if np.allclose(zoom, 1.0, atol=1e-3):
                continue
            arr = np.asarray(d[key])
            orig_shape = arr.shape[1:]
            order = 1 if mode == "bilinear" else 0
            d[key] = self._resample(arr, zoom, order)
            scale = np.asarray(orig_shape) / np.asarray(d[key].shape[1:])
            aff = meta["affine"].copy()
            aff[:3, :3] = aff[:3, :3] * scale[None, :]
            meta["affine"] = aff
            _push_record(
                d, key,
                {"op": "spacing", "orig_shape": orig_shape, "mode": mode},
            )
        return d


class SpatialPadd(MapTransform):
    """Symmetric pad to at least ``spatial_size``."""

    def __init__(self, keys, spatial_size: Sequence[int], mode="constant", allow_missing_keys: bool = False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.spatial_size = tuple(spatial_size)

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            arr = np.asarray(d[key])
            pads = [(0, 0)]
            needs = False
            for s, t in zip(arr.shape[1:], self.spatial_size):
                total = max(t - s, 0)
                lo = total // 2
                pads.append((lo, total - lo))
                needs = needs or total > 0
            if needs:
                orig_shape = arr.shape[1:]
                d[key] = np.pad(arr, pads, mode="constant")
                _push_record(
                    d, key,
                    {"op": "pad", "pads": pads[1:], "orig_shape": orig_shape},
                )
        return d


class CenterSpatialCropd(MapTransform):
    def __init__(self, keys, roi_size: Sequence[int], allow_missing_keys: bool = False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.roi_size = tuple(roi_size)

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            arr = np.asarray(d[key])
            slices = [slice(None)]
            for s, r in zip(arr.shape[1:], self.roi_size):
                start = max((s - r) // 2, 0)
                slices.append(slice(start, start + min(r, s)))
            d[key] = np.ascontiguousarray(arr[tuple(slices)])
        return d


# ---------------------------------------------------------------- random


class RandSpatialCropd(RandomizableTransform):
    def __init__(self, keys, roi_size: Sequence[int], random_size: bool = False, allow_missing_keys: bool = False) -> None:
        super().__init__(keys, prob=1.0, allow_missing_keys=allow_missing_keys)
        self.roi_size = tuple(roi_size)

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        ref = np.asarray(d[self.keys[0]])
        starts = [
            int(self.rng.integers(0, max(s - r, 0) + 1))
            for s, r in zip(ref.shape[1:], self.roi_size)
        ]
        slices = (slice(None), *[slice(a, a + r) for a, r in zip(starts, self.roi_size)])
        for key in self.key_iterator(d):
            d[key] = np.ascontiguousarray(np.asarray(d[key])[slices])
        return d


class RandCropByPosNegLabeld(RandomizableTransform):
    """Sample crops centered on foreground (pos) or background (neg) voxels."""

    def __init__(
        self,
        keys,
        label_key: str,
        spatial_size: Sequence[int],
        pos: float = 1.0,
        neg: float = 1.0,
        num_samples: int = 1,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob=1.0, allow_missing_keys=allow_missing_keys)
        self.label_key = label_key
        self.spatial_size = tuple(spatial_size)
        self.pos_ratio = pos / max(pos + neg, 1e-8)
        self.num_samples = num_samples

    def _center(self, label: np.ndarray) -> tuple[int, ...]:
        fg = np.any(label != 0, axis=0)
        use_pos = self.rng.random() < self.pos_ratio and fg.any()
        coords = np.nonzero(fg if use_pos else ~fg)
        if len(coords[0]) == 0:
            coords = tuple(np.arange(s) for s in fg.shape)
            idx = tuple(int(self.rng.integers(0, len(c))) for c in coords)
            return idx
        j = int(self.rng.integers(0, len(coords[0])))
        return tuple(int(c[j]) for c in coords)

    def __call__(self, data: dict) -> list[dict] | dict:
        d = dict(data)
        label = np.asarray(d[self.label_key])
        out = []
        for _ in range(self.num_samples):
            center = self._center(label)
            slices = [slice(None)]
            for c, r, s in zip(center, self.spatial_size, label.shape[1:]):
                start = int(np.clip(c - r // 2, 0, max(s - r, 0)))
                slices.append(slice(start, start + min(r, s)))
            sample = dict(d)
            for key in self.key_iterator(d):
                sample[key] = np.ascontiguousarray(np.asarray(d[key])[tuple(slices)])
            out.append(sample)
        return out if self.num_samples > 1 else out[0]


class RandAffined(RandomizableTransform):
    """Random rotation + scaling (resampled once via an affine grid)."""

    def __init__(
        self,
        keys,
        prob: float = 0.1,
        rotate_range: Sequence[float] = (0.0, 0.0, 0.0),
        scale_range: Sequence[float] = (0.0, 0.0, 0.0),
        mode: str | Sequence[str] = "bilinear",
        padding_mode: str = "border",
        spatial_size=None,
        cache_grid: bool = False,
        allow_missing_keys: bool = False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.rotate_range = rotate_range
        self.scale_range = scale_range
        self.modes = _as_seq(mode, len(self.keys))
        self.padding_mode = {"border": "nearest", "zeros": "constant", "reflection": "reflect"}.get(
            padding_mode, padding_mode
        )

    def _matrix(self, ndim: int) -> np.ndarray:
        # ranges shorter than ndim pad with 0 (no rotation / no scaling for
        # the missing dims), like MONAI RandAffine's None entries
        angles = [float(self.rng.uniform(-r, r)) for r in self.rotate_range[:ndim]]
        angles += [0.0] * (ndim - len(angles))
        scales = [1.0 + float(self.rng.uniform(-s, s)) for s in self.scale_range[:ndim]]
        scales += [1.0] * (ndim - len(scales))
        m = np.diag(scales)
        if ndim == 3:
            cx, sx = math.cos(angles[0]), math.sin(angles[0])
            cy, sy = math.cos(angles[1]), math.sin(angles[1])
            cz, sz = math.cos(angles[2]), math.sin(angles[2])
            rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
            ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            m = rx @ ry @ rz @ m
        elif ndim == 2:
            c, s = math.cos(angles[0]), math.sin(angles[0])
            m = np.array([[c, -s], [s, c]]) @ m
        return m

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        if not self._do():
            return d
        ref = np.asarray(d[self.keys[0]])
        ndim = ref.ndim - 1
        m = self._matrix(ndim)
        center = (np.asarray(ref.shape[1:]) - 1) / 2.0
        offset = center - m @ center
        for key, mode in zip(self.keys, self.modes):
            if key not in d:
                continue
            arr = np.asarray(d[key])
            order = 1 if mode == "bilinear" else 0
            out = None
            if ndim in (2, 3) and self.padding_mode in ("nearest", "constant"):
                # native fast path: coordinate transform + trilinear weights
                # computed once per voxel for ALL channels, slice-threaded.
                # 2-D runs as a depth-1 volume with an identity depth axis.
                from .native import native_affine_resample

                if ndim == 2:
                    m3 = np.eye(3)
                    m3[1:, 1:] = m
                    off3 = np.concatenate([[0.0], offset])
                    src = arr.astype(np.float32, copy=False)[:, None]
                else:
                    m3, off3, src = m, offset, arr.astype(np.float32, copy=False)
                out = native_affine_resample(
                    src, m3, off3, order=order, mode=self.padding_mode,
                    num_threads=_resample_threads(),
                )
                if out is not None and ndim == 2:
                    out = out[:, 0]
            if out is None:
                out = np.stack(
                    [
                        ndi.affine_transform(
                            c, m, offset=offset, order=order, mode=self.padding_mode, prefilter=False
                        )
                        for c in arr.astype(np.float32)
                    ],
                    axis=0,
                )
            d[key] = out if order == 1 else out.astype(arr.dtype)
        return d


class RandGaussianNoised(RandomizableTransform):
    def __init__(self, keys, prob=0.1, mean=0.0, std=0.1, allow_missing_keys=False) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.mean, self.std = mean, std

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        if not self._do():
            return d
        for key in self.key_iterator(d):
            arr = np.asarray(d[key])
            d[key] = arr + self.rng.normal(self.mean, self.std, arr.shape).astype(arr.dtype)
        return d


class RandGaussianSmoothd(RandomizableTransform):
    def __init__(
        self, keys, prob=0.1, sigma_x=(0.25, 1.5), sigma_y=(0.25, 1.5), sigma_z=(0.25, 1.5),
        allow_missing_keys=False,
    ) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.sigmas = (sigma_x, sigma_y, sigma_z)

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        if not self._do():
            return d
        for key in self.key_iterator(d):
            arr = np.asarray(d[key])
            ndim = arr.ndim - 1
            sig = [float(self.rng.uniform(*self.sigmas[i])) for i in range(ndim)]
            d[key] = np.stack([ndi.gaussian_filter(c, sig) for c in arr], axis=0)
        return d


class RandScaleIntensityd(RandomizableTransform):
    def __init__(self, keys, prob=0.1, factors=0.1, allow_missing_keys=False) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.factors = factors if isinstance(factors, (list, tuple)) else (-factors, factors)

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        if not self._do():
            return d
        factor = 1.0 + float(self.rng.uniform(*self.factors))
        for key in self.key_iterator(d):
            d[key] = np.asarray(d[key]) * factor
        return d


class RandShiftIntensityd(RandomizableTransform):
    def __init__(self, keys, prob=0.1, offsets=0.1, allow_missing_keys=False) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.offsets = offsets if isinstance(offsets, (list, tuple)) else (-offsets, offsets)

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        if not self._do():
            return d
        offset = float(self.rng.uniform(*self.offsets))
        for key in self.key_iterator(d):
            d[key] = np.asarray(d[key]) + offset
        return d


class RandFlipd(RandomizableTransform):
    def __init__(self, keys, prob=0.1, spatial_axis=0, allow_missing_keys=False) -> None:
        super().__init__(keys, prob, allow_missing_keys)
        self.spatial_axis = spatial_axis

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        if not self._do():
            return d
        for key in self.key_iterator(d):
            d[key] = np.ascontiguousarray(np.flip(np.asarray(d[key]), axis=self.spatial_axis + 1))
        return d


# ---------------------------------------------------------------- intensity


class NormalizeIntensityd(MapTransform):
    """Z-score normalization, optionally per-channel over nonzero voxels only."""

    def __init__(self, keys, nonzero: bool = False, channel_wise: bool = False, allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.nonzero = nonzero
        self.channel_wise = channel_wise

    def _normalize(self, x: np.ndarray) -> np.ndarray:
        mask = x != 0 if self.nonzero else np.ones_like(x, dtype=bool)
        if not mask.any():
            return x
        vals = x[mask]
        mean, std = vals.mean(), vals.std()
        out = x.copy()
        out[mask] = (vals - mean) / max(std, 1e-8)
        return out

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            arr = np.asarray(d[key], dtype=np.float32)
            if self.channel_wise:
                d[key] = np.stack([self._normalize(c) for c in arr], axis=0)
            else:
                d[key] = self._normalize(arr)
        return d


class ScaleIntensityRanged(MapTransform):
    def __init__(self, keys, a_min, a_max, b_min=0.0, b_max=1.0, clip=True, allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.a_min, self.a_max, self.b_min, self.b_max, self.clip = a_min, a_max, b_min, b_max, clip

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            arr = np.asarray(d[key], dtype=np.float32)
            arr = (arr - self.a_min) / (self.a_max - self.a_min)
            arr = arr * (self.b_max - self.b_min) + self.b_min
            if self.clip:
                arr = np.clip(arr, self.b_min, self.b_max)
            d[key] = arr
        return d


class EnsureTyped(MapTransform):
    def __init__(self, keys, dtype=None, track_meta: bool = True, allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.dtypes = _as_seq(dtype, len(self.keys))

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key, dt in zip(self.keys, self.dtypes):
            if key in d and dt is not None:
                d[key] = np.asarray(d[key], dtype=np.dtype(dt) if not isinstance(dt, type) else dt)
        return d


# ---------------------------------------------------------------- post


class Activationsd(MapTransform):
    def __init__(self, keys, sigmoid=False, softmax=False, allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.sigmoid, self.softmax = sigmoid, softmax

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            arr = np.asarray(d[key], dtype=np.float32)
            if self.sigmoid:
                arr = 1.0 / (1.0 + np.exp(-arr))
            elif self.softmax:
                e = np.exp(arr - arr.max(axis=0, keepdims=True))
                arr = e / e.sum(axis=0, keepdims=True)
            d[key] = arr
        return d


class AsDiscreted(MapTransform):
    def __init__(self, keys, threshold=None, argmax=False, to_onehot=None, allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.threshold, self.argmax, self.to_onehot = threshold, argmax, to_onehot

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            arr = np.asarray(d[key])
            if self.argmax:
                arr = np.argmax(arr, axis=0, keepdims=True)
            if self.to_onehot is not None:
                arr = np.stack([(arr[0] == c) for c in range(self.to_onehot)], axis=0)
            if self.threshold is not None:
                arr = (arr >= self.threshold)
            d[key] = arr.astype(np.uint8)
        return d


class SplitDimd(MapTransform):
    """Split the channel dim into per-channel keys (``pred`` -> ``pred_et``...)."""

    def __init__(self, keys, output_postfixes: Sequence[str], dim: int = 0, allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.postfixes = list(output_postfixes)
        self.dim = dim

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            arr = np.asarray(d[key])
            for i, post in enumerate(self.postfixes):
                d[f"{key}_{post}"] = np.take(arr, [i], axis=self.dim)
        return d


class Lambdad(MapTransform):
    def __init__(self, keys, func: Callable, allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.func = func

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            d[key] = self.func(d[key])
        return d


# ---------------------------------------------------------------- inversion


class Invertd(MapTransform):
    """Undo the recorded geometry transforms of ``orig_keys`` on ``keys``.

    Walks ``<orig_key>_transforms`` backwards, inverting pad / spacing /
    orientation / crop_foreground so predictions land back in the native image
    geometry (reference: evaluate.yaml:11-18 uses MONAI ``Invertd``).
    """

    def __init__(self, keys, orig_keys: str | Sequence[str], nearest_interp: bool = True, allow_missing_keys=False) -> None:
        super().__init__(keys, allow_missing_keys)
        self.orig_keys = [orig_keys] * len(self.keys) if isinstance(orig_keys, str) else list(orig_keys)
        self.nearest = nearest_interp

    def _invert_one(self, arr: np.ndarray, record: dict) -> np.ndarray:
        op = record["op"]
        if op == "pad":
            slices = [slice(None)]
            for (lo, _), orig in zip(record["pads"], record["orig_shape"]):
                slices.append(slice(lo, lo + orig))
            return arr[tuple(slices)]
        if op == "crop_foreground":
            out_shape = (arr.shape[0], *record["orig_shape"])
            out = np.zeros(out_shape, dtype=arr.dtype)
            slices = [slice(None)] + [
                slice(s, s + n) for s, n in zip(record["starts"], arr.shape[1:])
            ]
            out[tuple(slices)] = arr
            return out
        if op == "spacing":
            orig = record["orig_shape"]
            zoom = [o / c for o, c in zip(orig, arr.shape[1:])]
            order = 0 if self.nearest else 1
            out = Spacingd._resample(np.asarray(arr), zoom, order)
            # zoom rounding can be off by one voxel: crop/pad to the exact shape
            out = out[(slice(None), *[slice(0, o) for o in orig])]
            pads = [(0, 0)] + [(0, max(o - s, 0)) for o, s in zip(orig, out.shape[1:])]
            if any(hi for _, hi in pads):
                out = np.pad(out, pads)
            return out
        if op == "orientation":
            out = arr
            for ax, f in reversed(list(enumerate(record["flips"]))):
                if f:
                    out = np.flip(out, axis=ax + 1)
            inv_perm = np.argsort(record["perm"])
            return np.ascontiguousarray(np.transpose(out, (0, *[p + 1 for p in inv_perm])))
        raise ValueError(f"Unknown op {op!r}")

    def __call__(self, data: dict) -> dict:
        d = dict(data)
        for key, orig in zip(self.keys, self.orig_keys):
            if key not in d:
                continue
            records = d.get(f"{orig}_transforms", [])
            arr = np.asarray(d[key])
            for record in reversed(records):
                arr = self._invert_one(arr, record)
            d[key] = arr
            if f"{orig}_meta" in d:
                d[f"{key}_meta"] = {
                    "affine": d[f"{orig}_meta"]["original_affine"],
                    "filename": d[f"{orig}_meta"].get("filename"),
                }
        return d


class SaveImaged(MapTransform):
    def __init__(
        self, keys, output_dir: str, output_postfix: str = "pred",
        output_dtype=np.uint8, separate_folder: bool = False, allow_missing_keys=False,
    ) -> None:
        super().__init__(keys, allow_missing_keys)
        self.output_dir = output_dir
        self.output_postfix = output_postfix
        self.output_dtype = output_dtype
        self.separate_folder = separate_folder

    def __call__(self, data: dict) -> dict:
        import os

        d = dict(data)
        for key in self.key_iterator(d):
            arr = np.asarray(d[key], dtype=self.output_dtype)
            if arr.shape[0] == 1:
                arr = arr[0]
            meta = d.get(f"{key}_meta", {})
            affine = meta.get("affine")
            src = str(meta.get("filename", "pred.nii.gz"))
            base = os.path.basename(src).replace(".nii.gz", "").replace(".nii", "")
            folder = self.output_dir
            if self.separate_folder:
                folder = os.path.join(folder, base)
            os.makedirs(folder, exist_ok=True)
            path = os.path.join(folder, f"{base}_{self.output_postfix}.nii.gz")
            save_nifti(path, arr, affine)
            d[f"{key}_saved_path"] = path
        return d
