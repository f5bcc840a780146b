"""On the card, at a cell's own configuration and sizes, one fresh seed a cell: the program's readings keep to the
cell's limits, and the control (the reference at the configuration's ``precision.control`` in the program's place)
and every planted fault of the kind fail them, judged as a run judges (``port_bench/control.py``, which reads the
same over many seeds, from which the limits were set)."""

from __future__ import annotations

import json
import time

import pytest
import torch

from port_bench import control
from port_bench.bench import cell, program, spec

from .conftest import ROOT

pytestmark = pytest.mark.card

SEED = 2 ** 31 + 101
WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_keeps_to_the_limits_and_the_control_fails_them(card, workload):
    bench_cell = spec.load_cell(workload)
    dtype = cell.apply_precision(bench_cell.config["precision"])
    torch.backends.cudnn.benchmark = bool(bench_cell.traffic.get("cudnn_benchmark", False))
    program.load_kernels()
    ctx = cell.Context(SEED, 0.0, False, card, time.perf_counter(), dtype, spec.load_reference(bench_cell.config), {})
    out = control.judged(spec.load_kind(bench_cell.traffic["kind"]).readings(bench_cell, ctx, True, True),
                         bench_cell.limits)
    assert out["program"]["correct"], out
    for name in set(out) - {"program"}:
        assert not out[name]["correct"], (name, out)
