"""Profiling and cost analysis: FLOP counts, a latency sweep and a device trace.

PyTorch counterpart of ``factorizer_tpu/utils/profiling.py``.  FLOPs come from
``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix products
and convolutions by their shapes (two operations per multiply-add) and nothing
else, so elementwise work and the port's own kernels count 0; torch gives no
count of bytes accessed, so ``bytes_accessed`` is NaN.  Latency is the host's
clock around the calls, ended with ``torch.cuda.synchronize()`` on the card.
:func:`trace` writes a ``torch.profiler`` Chrome trace, in which the
program's :func:`span` names show.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["cost_analysis", "measure_latency", "profile_model", "span", "trace", "dump_profile"]

SPAN_PREFIX = "ftt."
_NO_SPAN = contextlib.nullcontext()


def _device_of(args: tuple) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cost_analysis(fn: Callable, *args: Any) -> dict:
    """``{"flops", "bytes_accessed", "transcendentals"}`` of one call ``fn(*args)``, run without a graph.

    ``flops`` is ``FlopCounterMode``'s total; ``bytes_accessed`` is NaN and
    ``transcendentals`` 0.0, as torch counts neither.
    """
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": float("nan"), "transcendentals": 0.0}


def measure_latency(fn: Callable, *args: Any, iters: int = 5, warmup: int = 1) -> float:
    """Mean wall-clock seconds per call of ``fn(*args)`` without a graph, after ``warmup`` calls."""
    device = _device_of(args)
    with torch.no_grad():
        for _ in range(warmup):
            fn(*args)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _sync(device)
    return (time.perf_counter() - t0) / iters


def profile_model(model: torch.nn.Module, sample_input: torch.Tensor, iters: int = 5) -> dict:
    """The profiler.py-style record for one model in evaluation mode: flops, params, latency, input shape, backend
    (the input's device type)."""
    model.eval()
    costs = cost_analysis(model, sample_input)
    return {
        "flops": costs["flops"],
        "bytes_accessed": costs["bytes_accessed"],
        "params": int(sum(p.numel() for p in model.parameters())),
        "latency_s": measure_latency(model, sample_input, iters=iters),
        "input_shape": list(sample_input.shape),
        "backend": sample_input.device.type,
    }


def span(name: str):
    """A phase of the program, named ``ftt.<name>`` in a ``torch.profiler`` trace.

    While a profiler records, the block runs inside
    ``torch.profiler.record_function("ftt." + name)``; otherwise it runs inside
    one shared no-op context: no allocation, no clock read, no CUDA event and
    no synchronisation.  A span never changes what the block computes.  The
    train step opens ``train.forward`` and ``train.backward`` per micro-batch
    and ``train.update`` once; the sliding window opens
    ``sliding_window.prepare`` and ``sliding_window.normalize`` once per call
    and ``sliding_window.gather`` / ``.predict`` / ``.blend`` per group of
    windows; ``ensemble_predict`` opens ``serve.combine`` around each fold's
    sigmoid and sum and around the final mean and threshold.
    """
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str | Path = "torch-trace") -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (the card's activity too where there is one) and write it to
    ``log_dir/trace.json`` as a Chrome trace."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))


def dump_profile(records: dict, path: str | Path) -> None:
    Path(path).write_text(json.dumps(records, indent=2))
