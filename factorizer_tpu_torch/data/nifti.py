"""Minimal NIfTI-1 reader/writer in pure numpy (supports .nii and .nii.gz).

The workflow layer's replacement for nibabel/MONAI ``LoadImage`` (the
reference delegates image IO to MONAI; reference:
model_zoo/factorizer_brats23/configs/train.yaml:88-92).  Implements the
NIfTI-1 single-file format: 348-byte header + optional extensions + voxel
data, with affine built from sform/qform (sform preferred).
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["NiftiImage", "load_nifti", "save_nifti"]

# NIfTI-1 datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    """An image volume + its geometry.

    Attributes:
        data: voxel array, spatial axes first (i, j, k[, t, ...]).
        affine: 4x4 voxel-to-world transform (RAS+ world convention).
        header: raw header fields useful for round-tripping.
    """

    data: np.ndarray
    affine: np.ndarray
    header: dict = field(default_factory=dict)

    @property
    def spacing(self) -> np.ndarray:
        return np.sqrt((self.affine[:3, :3] ** 2).sum(axis=0))


def _quaternion_to_affine(hdr: dict) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    pixdim = hdr["pixdim"]
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    S = np.diag([pixdim[1], pixdim[2], qfac * pixdim[3]])
    aff = np.eye(4)
    aff[:3, :3] = R @ S
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def _parse_header(raw: bytes) -> dict:
    if len(raw) < 348:
        raise ValueError("Not a NIfTI-1 file (header too short).")
    sizeof_hdr = struct.unpack("<i", raw[:4])[0]
    endian = "<"
    if sizeof_hdr != 348:
        sizeof_hdr = struct.unpack(">i", raw[:4])[0]
        if sizeof_hdr != 348:
            raise ValueError("Not a NIfTI-1 file (bad sizeof_hdr).")
        endian = ">"

    def u(fmt: str, off: int):
        vals = struct.unpack_from(endian + fmt, raw, off)
        return vals if len(vals) > 1 else vals[0]

    hdr: dict = {"endian": endian}
    hdr["dim"] = u("8h", 40)
    hdr["datatype"] = u("h", 70)
    hdr["bitpix"] = u("h", 72)
    hdr["pixdim"] = u("8f", 76)
    hdr["vox_offset"] = u("f", 108)
    hdr["scl_slope"] = u("f", 112)
    hdr["scl_inter"] = u("f", 116)
    hdr["qform_code"] = u("h", 252)
    hdr["sform_code"] = u("h", 254)
    hdr["quatern_b"] = u("f", 256)
    hdr["quatern_c"] = u("f", 260)
    hdr["quatern_d"] = u("f", 264)
    hdr["qoffset_x"] = u("f", 268)
    hdr["qoffset_y"] = u("f", 272)
    hdr["qoffset_z"] = u("f", 276)
    hdr["srow_x"] = u("4f", 280)
    hdr["srow_y"] = u("4f", 296)
    hdr["srow_z"] = u("4f", 312)
    hdr["magic"] = raw[344:348]
    if hdr["magic"][:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"Unsupported NIfTI magic {hdr['magic']!r}.")
    return hdr


def load_nifti(path: str | Path, dtype: Optional[np.dtype] = None) -> NiftiImage:
    """Load a .nii / .nii.gz volume with its affine.

    Uses the native C++ decoder (gzip inflate + cast in one pass, GIL
    released) when available and ``FTX_NATIVE != 0``; falls back to the pure
    numpy reader.  Note the native path always produces float32 voxels.
    """
    import os as _os

    if (
        _os.environ.get("FTX_NATIVE", "1") != "0"
        and dtype is not None
        and np.dtype(dtype) == np.float32
    ):
        from .native import native_load_nifti

        out = native_load_nifti(path)
        if out is not None:
            data, affine = out
            if dtype is not None:
                data = data.astype(dtype)
            return NiftiImage(data=data, affine=affine, header={"native": True})
    path = Path(path)
    opener = gzip.open if path.name.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()

    hdr = _parse_header(raw)
    ndim = hdr["dim"][0]
    shape = tuple(int(s) for s in hdr["dim"][1 : 1 + ndim])
    np_dtype = _DTYPES.get(hdr["datatype"])
    if np_dtype is None:
        raise ValueError(f"Unsupported NIfTI datatype code {hdr['datatype']}.")

    offset = int(hdr["vox_offset"])
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=offset)
    if hdr["endian"] == ">":
        data = data.byteswap()
    data = data.reshape(shape, order="F")  # NIfTI voxel data is Fortran-ordered

    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    # NIfTI convention (and nibabel): scl_slope == 0 means "no scaling at all"
    # — the intercept is ignored too, not applied on its own.
    if slope != 0.0 and (slope != 1.0 or inter != 0.0):
        data = data.astype(np.float32) * slope + inter
    if dtype is not None:
        data = data.astype(dtype)
    else:
        data = np.asarray(data)

    if hdr["sform_code"] > 0:
        affine = np.array([hdr["srow_x"], hdr["srow_y"], hdr["srow_z"], [0, 0, 0, 1]], dtype=np.float64)
    elif hdr["qform_code"] > 0:
        affine = _quaternion_to_affine(hdr)
    else:
        affine = np.diag([*hdr["pixdim"][1:4], 1.0]).astype(np.float64)

    return NiftiImage(data=data, affine=affine, header=hdr)


def save_nifti(
    path: str | Path,
    data: np.ndarray,
    affine: Optional[np.ndarray] = None,
    compresslevel: int = 1,
) -> None:
    """Write a .nii / .nii.gz volume (sform affine, float32/int types).

    ``compresslevel`` defaults to 1 (nibabel's default): Python's gzip
    default of 9 is ~30x slower on poorly-compressible volumes for a few
    percent of size.
    """
    path = Path(path)
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    affine = np.eye(4) if affine is None else np.asarray(affine, dtype=np.float64)

    ndim = data.ndim
    dim = [ndim, *data.shape] + [1] * (7 - ndim)
    spacing = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    pixdim = [1.0, *spacing.tolist()] + [1.0] * (7 - max(ndim, 3))
    pixdim = (pixdim + [1.0] * 8)[:8]

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(data.dtype)])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code: scanner
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    if path.name.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=compresslevel) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
