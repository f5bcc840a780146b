"""Arithmetic the metric readers share: device time of kernel groups per unit, roofline shares, MFU.

A roofline share is the least time the card could take for a kernel's work in
the traced units (its ``kernels/<kernel>.py``: ``bench.work``'s bounds at the
cell's shapes) over the device time of the kernels its ``NAMES`` find.  The work assumes the kernel's launches: a
reading whose launch count differs from what the work assumes is an error,
never a share.  A kernel with no launch and no device time in the traced units
gives no reading (None): the metric is then left out of the line.
"""

from __future__ import annotations

import re

import torch

from . import groups, spec, work


def group_seconds(run, names) -> float:
    by_group = groups.by_group(run.trace["by_kernel"])
    return sum(by_group.get(g, 0.0) for g in names)


def per_unit_ms(run, names) -> float | None:
    seconds = group_seconds(run, names)
    return None if seconds == 0 else 1e3 * seconds / run.traced_units


def calls(run) -> tuple[int, bool]:
    """(forward calls in the traced units, whether each has a backward)."""
    if run.kind == "train":
        return run.traced_units, True
    return run.traced_calls, False


def block_metas(run) -> list:
    """``meta`` tensors of every U-Net block's channels-last shape at the traced calls' batch and the run's dtype."""
    batch = run.traffic["batch"] if run.kind == "train" else run.traffic["sw_batch"]
    return [work.meta(s, run.dtype) for s in work.block_shapes(run.net, batch, run.traffic["roi"])]


def kernel_seconds(run, names: str) -> float:
    """Device seconds in the traced units of the kernels whose names ``names`` (a regular expression) finds."""
    pattern = re.compile(names)
    return sum(t for name, t in run.trace["by_kernel"].items() if pattern.search(name))


def roofline_share(run, kernel: str) -> float | None:
    """100 x the bound of ``kernel``'s work in the traced units (``kernels/<kernel>.py``) over its device time
    there; None where it neither launched nor ran."""
    k = spec.load_kernel(kernel)
    n_calls, backward = calls(run)
    bound_ms, expected = k.work(run, n_calls, backward)
    seen = {name: run.launches.get(name, 0) for name in expected}
    seconds = kernel_seconds(run, k.NAMES)
    if not any(seen.values()) and seconds == 0:
        return None
    if seen != expected:
        raise ValueError(f"{kernel}: launches {seen} in the traced units, the work assumes {expected}")
    return 100.0 * bound_ms / (1e3 * seconds)


def peak_flops(run) -> float:
    """The card's published peak for the precision the cell states: its dtype's (TF32's where TF32 is on for
    float32)."""
    name = "tf32" if run.dtype == torch.float32 and run.tf32 else work.dname(run.dtype)
    return work.PEAK_FLOPS[name]


def mfu(run) -> float:
    """100 x the reference's FLOPs of the window's units over the window's time at the cell's peak."""
    flops = run.flops_unit * run.units if run.kind == "train" else run.flops_call * run.window_calls
    return 100.0 * flops / run.window_s / peak_flops(run)


def device_idle(run) -> float:
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
