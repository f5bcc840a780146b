"""ctypes bindings for the native NIfTI decoder (with transparent fallback).

Compiles ``_native/nifti_decode.cpp`` on first use into a per-user cache dir
(g++ -O3 -shared, links zlib) and exposes :func:`native_load_nifti`.  If the
toolchain or zlib is unavailable the import still succeeds and callers fall
back to the pure-numpy reader in :mod:`.nifti` beside this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "native_available",
    "native_load_nifti",
    "native_affine_resample",
    "get_library",
]

_SOURCES = [
    Path(__file__).parent / "_native" / "nifti_decode.cpp",
    Path(__file__).parent / "_native" / "affine_resample.cpp",
]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[ctypes.CDLL]:
    src = "".join(p.read_text() for p in _SOURCES)
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    cache = Path(os.environ.get("FTX_NATIVE_CACHE", Path(tempfile.gettempdir()) / "ftx_native"))
    cache.mkdir(parents=True, exist_ok=True)
    so = cache / f"ftx_data_native_{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(".so.tmp")
        cmd = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC",
            *[str(p) for p in _SOURCES], "-o", str(tmp), "-lz", "-lpthread",
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError):
            return None
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.ftx_nifti_load.restype = ctypes.c_int
    lib.ftx_nifti_load.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_char_p,
    ]
    lib.ftx_free.restype = None
    lib.ftx_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.ftx_affine_resample.restype = ctypes.c_int
    lib.ftx_affine_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # src
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # C, D0-2
        ctypes.POINTER(ctypes.c_double),  # matrix (9)
        ctypes.POINTER(ctypes.c_double),  # offset (3)
        ctypes.POINTER(ctypes.c_float),  # dst
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # O0-2
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ]
    return lib


def get_library() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                _lib = _build()
                _tried = True
    return _lib


def native_available() -> bool:
    return get_library() is not None


def native_load_nifti(path: str | os.PathLike):
    """Decode a .nii/.nii.gz via the native library.

    Returns ``(data, affine)`` with ``data`` float32 in NIfTI voxel order, or
    ``None`` if the native path is unavailable/failed (caller falls back).
    """
    lib = get_library()
    if lib is None:
        return None

    data_ptr = ctypes.POINTER(ctypes.c_float)()
    shape = (ctypes.c_int64 * 8)()
    affine = (ctypes.c_double * 16)()
    err = ctypes.create_string_buffer(256)
    rc = lib.ftx_nifti_load(str(path).encode(), ctypes.byref(data_ptr), shape, affine, err)
    if rc != 0:
        return None
    try:
        ndim = int(shape[0])
        dims = tuple(int(shape[1 + i]) for i in range(ndim))
        count = int(np.prod(dims))
        flat = np.ctypeslib.as_array(data_ptr, shape=(count,))
        # NIfTI voxel data is i-fastest: C-flat buffer + Fortran reshape.
        data = np.array(flat, dtype=np.float32, copy=True).reshape(dims, order="F")
    finally:
        lib.ftx_free(data_ptr)
    aff = np.array(affine, dtype=np.float64).reshape(4, 4)
    return data, aff


def native_affine_resample(
    arr: np.ndarray,
    matrix: np.ndarray,
    offset: np.ndarray,
    order: int = 1,
    mode: str = "nearest",
    cval: float = 0.0,
    output_shape: Optional[tuple] = None,
    num_threads: int = 0,
) -> Optional[np.ndarray]:
    """Multi-channel 3-D affine resample, scipy.ndimage semantics.

    ``arr`` is ``(C, D0, D1, D2)``; the sample point for output index ``o``
    is ``matrix @ o + offset`` (matching ``ndi.affine_transform`` with
    ``prefilter=False``).  The coordinate transform and trilinear weights
    are computed once per voxel and reused across all C channels (scipy
    redoes them per channel), with slice-parallel worker threads.  Returns
    ``None`` when unavailable or unsupported (caller falls back to scipy).
    """
    lib = get_library()
    if lib is None or arr.ndim != 4 or order not in (0, 1):
        return None
    pad_mode = {"nearest": 0, "constant": 1}.get(mode)
    if pad_mode is None:
        return None
    src = np.ascontiguousarray(arr, dtype=np.float32)
    m = np.ascontiguousarray(matrix, dtype=np.float64).reshape(9)
    off = np.ascontiguousarray(offset, dtype=np.float64).reshape(3)
    out_sp = tuple(output_shape) if output_shape is not None else src.shape[1:]
    dst = np.empty((src.shape[0], *out_sp), dtype=np.float32)
    rc = lib.ftx_affine_resample(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.shape[0], src.shape[1], src.shape[2], src.shape[3],
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_sp[0], out_sp[1], out_sp[2],
        int(order), pad_mode, float(cval), int(num_threads),
    )
    return dst if rc == 0 else None
