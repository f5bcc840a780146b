"""One run of one cell: what every kind of traffic shares, and the result line.

:func:`run_cell` does everything but look for the card, so the tests drive it on the CPU at a small size;
``port_bench/run.py`` is the command.  It applies the configuration's stated precision, loads the runner of the
traffic's kind (``kinds/<kind>.py``, :func:`spec.load_kind`) and the configuration's reference
(:func:`spec.load_reference`), and hands them a :class:`Context`.  The runner does the rest:

* set-up (``setup_s``, from the start of the command to the first timed unit): importing, building or loading the
  program's kernels, building the networks through the program's ``ConfigParser``, loading the benchmark's
  tensors into them, making the inputs, counting the reference's FLOPs and warming up every shape the window uses;
* the window: units back to back until ``seconds`` have passed on the host clock, ending in a synchronize; every
  unit enqueued in it is counted, and its time is all of the window's;
* with ``trace``, a few more units under the profiler (:func:`traced`), with the launch counters of the kernels
  that the cell's metrics read;
* the device's peak, read before the program's state is freed; then the reference's check, whose numbers
  :func:`check.judge` holds to the cell's limits.
"""

from __future__ import annotations

import contextlib
import gc
import sys
from dataclasses import dataclass
from types import ModuleType

import torch

from . import check, spec, trace, weights

FORBIDDEN = ("jax", "jaxlib", "flax", "factorizer_tpu")


def apply_precision(precision: dict) -> torch.dtype:
    """TF32 for matrix products and convolutions as ``precision["tf32"]`` states; the dtype it states."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(precision["tf32"])
    return getattr(torch, precision["dtype"])


@contextlib.contextmanager
def precision(stated: dict):
    """:func:`apply_precision` inside the block, the flags as they were after it; yields the dtype."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        yield apply_precision(stated)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def held_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the benchmark makes tensors and inputs in, and the reference computes in: the stated dtype, and
    float32 where that is narrower (a 16-bit cell computes in 16 bits as its ``network_def`` says, from float32
    weights and images, as the bundles hold them)."""
    return dtype if torch.finfo(dtype).bits >= 32 else torch.float32


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def free_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@dataclass
class Context:
    """What a kind's runner is handed: the run's arguments, the stated dtype, the reference and the counters."""

    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    dtype: torch.dtype
    reference: ModuleType
    counters: dict

    @property
    def held(self) -> torch.dtype:
        return held_dtype(self.dtype)


class Forward:
    """One fold's network as ``ensemble_predict`` calls it, inside a benchmark span, counting its calls; with
    ``events`` a list, CUDA events around each call go there."""

    def __init__(self, model: torch.nn.Module) -> None:
        self.model = model
        self.calls = 0
        self.events = None

    def __call__(self, windows: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        with trace.span("forward"):
            if self.events is None:
                return self.model(windows)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.model(windows)
            end.record()
            self.events.append((start, end))
            return out


def program_network(cell: spec.Cell, ctx: Context, spec_: dict, stream: int) -> torch.nn.Module:
    """The program's network as the cell's configuration builds it (a stated dtype wider than float32 casts its
    parameters), holding the seed's tensors of ``stream``."""
    from . import program

    model = program.build_network(cell.config, ctx.device)
    if ctx.held != torch.float32:
        model = model.to(ctx.held)
    model.load_state_dict(weights.make_weights(spec_, ctx.seed, stream, ctx.device, ctx.held), strict=True)
    return model


def traced(run_units, ctx: Context) -> tuple[dict, dict]:
    """``run_units()`` under the profiler: (its reduced trace, the launches of the counters in ``ctx``)."""
    from . import program

    before = program.read_counters(ctx.counters)
    reduced = trace.traced(run_units, ctx.device)
    after = program.read_counters(ctx.counters)
    return reduced, {k: after[k] - before[k] for k in after}


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reset_peak(device) -> None:
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, do_trace: bool, device, t0: float) -> dict:
    """One run of ``cell``; the result line's object (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, ``breakdown`` where traced, ``checks`` last)."""
    device = torch.device(device)
    dtype = apply_precision(cell.config["precision"])
    torch.backends.cudnn.benchmark = bool(cell.traffic.get("cudnn_benchmark", False))
    readers = {m["name"]: (m, spec.load_metric(m["name"])) for m in (cell.per_layer if do_trace else cell.end_to_end)}
    counters = {}
    for _, module in readers.values():
        if getattr(module, "KERNEL", None):
            counters.update(spec.load_kernel(module.KERNEL).COUNTERS)
    ctx = Context(seed, seconds, do_trace, device, t0, dtype, spec.load_reference(cell.config), counters)
    run = spec.load_kind(cell.traffic["kind"]).run(cell, ctx)
    print(f"run.py: the reference's check took {run.reference_s:.1f} s", file=sys.stderr)
    run.cell, run.net, run.traffic, run.config = cell, cell.config["network_def"], cell.traffic, cell.config
    run.dtype, run.tf32 = dtype, bool(cell.config["precision"]["tf32"])
    ok, shown = check.judge(run.numbers, cell.limits)
    for name in sorted(set(run.numbers) - set(shown)):
        print(f"run.py: reading {name} = {run.numbers[name]!r} (not compared)", file=sys.stderr)
    correct = ok and run.failed == 0 and run.units > 0
    metrics = {}
    for name, (m, module) in readers.items():
        value = module.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result = {"correct": correct, "attempted": run.units, "failed": run.failed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": run.peak_bytes}}
    if do_trace:
        result["device"].update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        result["breakdown"] = {"device_ops": trace.top(run.trace["by_kernel"]), "idle_gaps": trace.top(run.trace["gaps"])}
    result["checks"] = shown
    return result
