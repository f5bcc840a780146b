"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All ``csrc/*.cu`` sources compile, at first use, into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds).  Each
source gets its own nvcc, all started together, and one more links the objects:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c <source>
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <library> <objects>

The library lands in ``factorizer_tpu_torch/build/`` (listed in .gitignore),
named by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing here runs at import time.

Every C entry point returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero status.  Kernels launch on PyTorch's current stream, allocate
nothing and never synchronise.

:func:`reference_kernels` is the one switch that sends the wrappers of CUDA
tensors to their plain PyTorch versions, for a whole-model comparison on the
card.  It is off unless a caller enters it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Iterator

import torch

__all__ = ["nvcc_path", "build", "build_info", "library", "check", "check_aligned", "dtype_code", "stream_of",
           "reference_kernels", "launches_kernel"]

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    # x, U, V, u0, v0, dtype, B, S1, S2, S3, C, d, p, n_shifts, shifts, mu, num_iters, eps, stream
    "ftt_windowed_nmf_factors": [_P] * 5 + [_I] * 9 + [_P, _I, _I, _F, _P],
    # U, V, acc, out, dtype, B, S1, S2, S3, C, d, p, n_shifts, shifts, stream
    "ftt_windowed_nmf_reconstruct": [_P] * 4 + [_I] * 9 + [_P, _P],
    # x, U, V, acc, out, u0, v0, dtype, B, S1, S2, S3, C, d, p, n_shifts, shifts, mu, num_iters, eps, stream
    "ftt_windowed_nmf_forward": [_P] * 7 + [_I] * 9 + [_P, _I, _I, _F, _P],
    # M, C, H, shares (out)
    "ftt_prenorm_mlp_shares": [_L, _I, _I, ctypes.POINTER(ctypes.c_int)],
    # x, y, gamma, beta, w1, b1, w2, b2, partial, wconv, dtype, M, C, H, eps, stream
    "ftt_prenorm_mlp": [_P] * 10 + [_I, _L, _I, _I, _F, _P],
    # x, g, acc, out, u0, v0, dtype, B, S1, S2, S3, C, d, p, sh1, sh2, sh3, mu,
    # num_iters, grad_steps, eps, first, last, scale, stream
    "ftt_windowed_nmf_shift_bwd": [_P] * 6 + [_I] * 14 + [_F, _I, _I, _F, _P],
    # M, C, H, dtype, floats (out)
    "ftt_prenorm_mlp_bwd_scratch": [_L, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong)],
    # x, g, dx, gamma, beta, w1, b1, w2, b2, scratch, floats, grads, dtype, M, C, H, eps, stream
    "ftt_prenorm_mlp_bwd": [_P] * 10 + [_L, _P, _I, _L, _I, _I, _F, _P],
    # x, w, y, dtype, B, S1, S2, S3, C, k1, k2, k3, route, t2, t3, cb, planes, stream
    "ftt_depthwise_conv": [_P] * 3 + [_I] * 14 + [_P],
    # x, g, partials, dw, dtype, B, S1, S2, S3, C, k1, k2, k3, route, t2, t3, cb, planes, blocks, stream
    "ftt_depthwise_conv_dw": [_P] * 4 + [_I] * 15 + [_P],
    # S1, S2, S3, C, k1, k2, k3, elt, dw, t2, t3, cb, planes, out (7 ints)
    "ftt_depthwise_conv_tile_query": [_I] * 13 + [ctypes.POINTER(ctypes.c_int)],
    # x, y, u0, v0, dtype, n_mats, M, N, rank, mu, num_iters, eps, stream
    "ftt_nmf_reconstruct": [_P] * 4 + [_I, _L] + [_I] * 5 + [_F, _P],
    # x, g, dx, u0, v0, dtype, n_mats, M, N, mu, num_iters, grad_steps, eps, stream
    "ftt_nmf_reconstruct_bwd": [_P] * 5 + [_I, _L] + [_I] * 5 + [_F, _P],
    # x, halo, acc, out, send, u0, v0, dtype, B, L, S2, S3, C, d, p, sh1, sh2, sh3, mu, num_iters, eps, first,
    # last, scale, stream
    "ftt_windowed_nmf_slab_shift": [_P] * 7 + [_I] * 13 + [_F, _I, _I, _F, _P],
    # x, g, x_halo, g_halo, acc, out, send, u0, v0, dtype, B, L, S2, S3, C, d, p, sh1, sh2, sh3, mu, num_iters,
    # grad_steps, eps, first, last, scale, stream
    "ftt_windowed_nmf_slab_shift_bwd": [_P] * 9 + [_I] * 14 + [_F, _I, _I, _F, _P],
    # recv, acc, out, dtype, B, L, R, sh1, first, last, scale, stream
    "ftt_windowed_nmf_slab_tail": [_P] * 3 + [_I, _I, _I, _L, _I, _I, _I, _F, _P],
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_state = {"lib": None, "build_seconds": None, "build_log": "", "reference": False}


def nvcc_path() -> str:
    """The nvcc to build with: the one on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit on PATH")


def build() -> Path:
    """Compile ``csrc/*.cu`` into the build directory unless an identical build exists."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    digest = hashlib.sha256()
    for path in (*sources, *headers):
        digest.update(path.name.encode() + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libftt_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objects = [Path(objdir) / f"{src.stem}.o" for src in sources]
        compiles = []
        for src, obj in zip(sources, objects):
            with open(obj.with_suffix(".log"), "w") as log:  # a file, so no compile waits on a full pipe
                compiles.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                                 stdout=log, stderr=subprocess.STDOUT))
        for proc in compiles:
            proc.wait()
        logs = [obj.with_suffix(".log").read_text() for obj in objects]
        for src, proc, log in zip(sources, compiles, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, out)
    _state["build_seconds"] = time.perf_counter() - t0
    _state["build_log"] = "".join(logs)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    if _state["lib"] is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ftt_error_string.argtypes = [ctypes.c_int]
        lib.ftt_error_string.restype = ctypes.c_char_p
        _state["lib"] = lib
    return _state["lib"]


def build_info() -> tuple[float | None, str]:
    """Seconds the last build in this process took (None if it was reused) and nvcc's output."""
    return _state["build_seconds"], _state["build_log"]


def check(status: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if status != 0:
        msg = library().ftt_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def check_aligned(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t``'s data starts on a 16-byte boundary, as the kernels' 16-byte accesses need.  Fresh
    tensors do; a view into another tensor may not."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (pass a fresh contiguous copy)")


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16 activations, got {dtype}")
    return _DTYPE_CODES[dtype]


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s card, as the handle the C entry points take."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, but the current device is cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream


@contextlib.contextmanager
def reference_kernels() -> Iterator[None]:
    """Within this context, the wrappers run their plain PyTorch versions on CUDA tensors too."""
    previous = _state["reference"]
    _state["reference"] = True
    try:
        yield
    finally:
        _state["reference"] = previous


def launches_kernel(x: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel for ``x``: CUDA tensors do, CPU tensors take the plain
    version; any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"kernels run on CUDA tensors; got a tensor on {x.device}")
    return not _state["reference"]
