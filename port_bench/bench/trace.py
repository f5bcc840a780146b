"""Spans and the profiler's trace, reduced to what the per-layer metrics and the breakdown read.

Host spans are the benchmark's own: ``span(name)`` opens a
``torch.profiler.record_function`` named ``port_bench.<name>`` around a call
into the program, which shows in a trace.  :func:`traced` runs a few units
under ``torch.profiler`` (CPU and CUDA activities), exports the trace and
reduces it:

* device seconds by kernel name (kernels, copies and sets on the device);
* ``busy_s``: the union of those operations' intervals, and ``window_s``,
  the host clock around the traced units, which end in a synchronize;
* idle gaps: the stretches between the merged device intervals, each named
  by the innermost benchmark span open on the host at the gap's start
  (``"no span"`` where none is).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "port_bench."


def span(name: str):
    return torch.profiler.record_function(PREFIX + name)


def _merge(intervals: list) -> list:
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def reduce_events(events: list) -> dict:
    """A chrome trace's ``traceEvents`` -> by-kernel seconds, busy seconds and idle gaps by host span (seconds)."""
    device, spans = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        start, end = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        if ev.get("cat") in DEVICE_CATS:
            device.append((start, end, ev.get("name", "?")))
        elif ev.get("cat") == "user_annotation" and str(ev.get("name", "")).startswith(PREFIX):
            spans.append((start, end, ev["name"][len(PREFIX):]))
    by_kernel: dict = {}
    for start, end, name in device:
        by_kernel[name] = by_kernel.get(name, 0.0) + (end - start) * 1e-6
    merged = _merge([(s, e) for s, e, _ in device])
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps: dict = {}
    for (_, prev_end), (nxt, _) in zip(merged, merged[1:]):
        open_spans = [sp for sp in spans if sp[0] <= prev_end < sp[1]]
        name = min(open_spans, key=lambda sp: sp[1] - sp[0])[2] if open_spans else "no span"
        gaps[name] = gaps.get(name, 0.0) + (nxt - prev_end) * 1e-6
    return {"by_kernel": by_kernel, "busy_s": busy, "gaps": gaps}


def traced(run_units, device) -> dict:
    """Run ``run_units()`` under the profiler; its reduced trace and ``window_s``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    if device.type == "cuda":
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run_units()
        if device.type == "cuda":
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.remove(path)
    out = reduce_events(events)
    out["window_s"] = window
    return out


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
