"""What a run reads, found by name: the cell in ``BENCHMARK.json``, its configuration, traffic mix, limits, the
runner of its kind of traffic, its reference, its metrics and the kernels they read.

Everything that belongs to one configuration, one traffic mix, one kind of traffic, one cell's correctness limits,
one per-layer metric or one kernel's roofline sits in a file of its own under the benchmark's folder, named after
it:

    configs/<config>.json     the configuration as it is run (a bundle's network_def and training settings, its
                              stated precision, and ``reference``: the path of its plain reference's module)
    traffic/<traffic>.json    the traffic mix's parameters; its ``kind`` names the runner
    kinds/<kind>.py           the runner of one kind of traffic (set-up, window, traced units, the check)
    limits/<workload>.json    the limits of the numbers that decide ``correct``
    metrics/<metric>.py       the reader of one metric
    kernels/<kernel>.py       one kernel's launch counters, device names and work, for its roofline readers
    reference/<family>.py     one model family's plain reference (``param_spec``, ``forward``)

so a cell, a configuration, a kind of traffic, a metric or a kernel is added with files and entries, and no file
here changes.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_DIR = BENCH_DIR.parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything a run of it reads."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_applies(metric: dict, workload: str, reported: set) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is reported in ``workload``: listed there, or (with no ``workloads``
    key) in every cell that reports the end-to-end metric ``reported`` holds for it."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(workload: str, benchmark: Path | dict | None = None, root: Path | None = None) -> Cell:
    """The cell ``workload`` of ``benchmark`` (a path or its parsed object; default: ``BENCHMARK.json`` at the
    repository's root): its configuration from the entry's ``file`` (relative to the repository's root), its
    traffic and limits from ``root`` (default: this folder)."""
    bench = benchmark if isinstance(benchmark, dict) else load_json(benchmark or REPO_DIR / "BENCHMARK.json")
    root = root or BENCH_DIR
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in the benchmark; it has {[w['name'] for w in bench['workloads']]}")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"] if metric_applies(m, workload, names)]
    return Cell(
        name=workload, chips=int(entry["chips"]), config_name=entry["config"],
        config=load_json(REPO_DIR / config["file"]),
        traffic_name=entry["traffic"], traffic=load_json(root / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(root / "limits" / f"{workload}.json"), end_to_end=e2e, per_layer=layers,
    )


@functools.lru_cache(maxsize=None)
def load_module(path: Path):
    """The Python file ``path``, loaded once as a module of its own."""
    path = Path(path).resolve()
    rel = path.relative_to(REPO_DIR) if path.is_relative_to(REPO_DIR) else Path(path.name)
    name = "port_bench_file_" + "_".join(rel.with_suffix("").parts).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_metric(name: str, root: Path | None = None):
    """The reader module of the metric ``name`` (``metrics/<name>.py``)."""
    return load_module((root or BENCH_DIR) / "metrics" / f"{name}.py")


def load_kind(kind: str):
    """The runner of the traffic kind ``kind`` (``kinds/<kind>.py``)."""
    return load_module(BENCH_DIR / "kinds" / f"{kind}.py")


def load_kernel(name: str):
    """One kernel's counters, device names and work (``kernels/<name>.py``)."""
    return load_module(BENCH_DIR / "kernels" / f"{name}.py")


def load_reference(config: dict):
    """The plain reference of the configuration's model family: the module at its ``reference`` path (relative to
    the repository's root), with ``param_spec(net, roi)`` and ``forward(params, x, net)``."""
    return load_module(REPO_DIR / config["reference"])
