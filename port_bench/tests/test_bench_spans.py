"""The program's spans in a trace (``bench/spans.py``): attribution by launch on a synthetic chrome trace, the
harness's own reduction of the same events unchanged, and tiny traced runs on the CPU that carry the reduction and
read no per-phase metric."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from port_bench.bench import cell, spans, spec, trace

SEED = 2 ** 31 + 91
MAIN, AUTOGRAD = 1, 2


def _x(cat: str, name: str, ts: float, dur: float, tid: int = MAIN, **args) -> dict:
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}
    if args:
        ev["args"] = args
    return ev


def _events() -> list:
    """A step's forward and backward, then a served case's prepare and gather, on one timeline (microseconds).

    * kernel 1 is launched in ``train.forward`` and runs inside it;
    * kernel 2 is launched from autograd's thread while ``train.backward`` is open on the main thread, and runs
      after that span has ended, inside ``train.update``;
    * the device idles from 130 to 150, a gap that opens inside ``sliding_window.prepare``;
    * kernel 4 is launched inside the benchmark's span alone, outside every program span;
    * the copy has no launch in the trace.
    """
    return [
        _x("user_annotation", "port_bench.train.step", 0, 100),
        _x("user_annotation", "ftt.train.forward", 5, 25),
        _x("user_annotation", "ftt.train.backward", 30, 30),
        _x("user_annotation", "ftt.train.update", 60, 35),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
        _x("kernel", "k_forward", 20, 15, tid=7, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 40, 2, tid=AUTOGRAD, correlation=2),
        _x("kernel", "k_backward", 70, 20, tid=7, correlation=2),
        _x("user_annotation", "port_bench.serve.case", 100, 110),
        _x("user_annotation", "ftt.sliding_window.prepare", 105, 40),
        _x("cuda_driver", "cuLaunchKernel", 106, 2, correlation=3),
        _x("kernel", "k_pad", 110, 20, tid=7, correlation=3),
        _x("user_annotation", "ftt.sliding_window.gather", 145, 10),
        _x("cuda_runtime", "cudaMemcpyAsync", 160, 2, correlation=4),
        _x("kernel", "k_outside", 165, 5, tid=7, correlation=4),
        _x("gpu_memcpy", "Memcpy HtoD", 150, 10, tid=7, correlation=99),
    ]


def test_program_spans_attribute_by_launch():
    out = spans.reduce_program_spans(_events())
    table = out["spans"]
    assert {k: v["opened"] for k, v in table.items()} == {"train.forward": 1, "train.backward": 1, "train.update": 1,
                                                          "sliding_window.prepare": 1, "sliding_window.gather": 1}
    assert table["train.forward"]["device_s"] == pytest.approx(15e-6)
    assert table["train.backward"]["device_s"] == pytest.approx(20e-6)  # its device time falls in train.update
    assert table["train.update"]["device_s"] == 0
    assert table["sliding_window.prepare"]["device_s"] == pytest.approx(20e-6)
    assert out["outside_device_s"] == pytest.approx(5e-6)
    assert out["unmatched_device_s"] == pytest.approx(10e-6)
    # gaps: 35 -> 70 opens in train.backward (35 < 60), 90 -> 110 in train.update, 130 -> 150 in prepare
    assert table["train.backward"]["idle_s"] == pytest.approx(35e-6)
    assert table["train.update"]["idle_s"] == pytest.approx(20e-6)
    assert table["sliding_window.prepare"]["idle_s"] == pytest.approx(20e-6)
    assert table["train.forward"]["idle_s"] == table["sliding_window.gather"]["idle_s"] == 0
    assert out["outside_idle_s"] == pytest.approx(5e-6)  # 160 -> 165, after gather has closed


def test_harness_reduction_of_the_same_events_is_unchanged():
    """``trace.reduce_events`` still names gaps by the benchmark's spans alone, and :func:`spans.install` leaves it
    the harness's own function."""
    spans.install()
    out = trace.reduce_events(_events())
    assert set(out) == {"by_kernel", "busy_s", "gaps"}
    assert out["by_kernel"] == pytest.approx({"k_forward": 15e-6, "k_backward": 20e-6, "k_pad": 20e-6,
                                              "k_outside": 5e-6, "Memcpy HtoD": 10e-6})
    assert out["busy_s"] == pytest.approx(70e-6)
    assert out["gaps"] == pytest.approx({"train.step": 55e-6, "serve.case": 25e-6})
    assert trace.reduce_events.__module__ == trace.__name__


def test_readers_on_the_synthetic_trace():
    """Each reader takes its spans' seconds over the traced units, in ms; none reads without device time in a
    program span."""
    run = SimpleNamespace(kind="train", traced_units=2, trace={"program": spans.reduce_program_spans(_events())})
    assert spec.load_metric("backward_ms.train").read(run) == pytest.approx(1e3 * 20e-6 / 2)
    assert spec.load_metric("update_idle_ms.train").read(run) == pytest.approx(1e3 * 20e-6 / 2)
    assert spec.load_metric("update_ms.train").read(run) == 0
    assert spec.load_metric("sw_idle_ms.serve").read(run) is None  # a train run
    run.kind = "serve"
    assert spec.load_metric("sw_gather_ms.serve").read(run) == pytest.approx(1e3 * 20e-6 / 2)
    assert spec.load_metric("sw_idle_ms.serve").read(run) == pytest.approx(1e3 * 20e-6 / 2)
    no_device = [ev for ev in _events() if ev["cat"] not in trace.DEVICE_CATS]
    run.trace = {"program": spans.reduce_program_spans(no_device)}
    assert spec.load_metric("sw_gather_ms.serve").read(run) is None
    run.trace = {}
    assert spec.load_metric("sw_gather_ms.serve").read(run) is None


@pytest.mark.parametrize("workload", ["factorizer_brats23.train", "deconver_brats23.train"])
def test_tiny_traced_run_carries_the_program_spans(tiny, monkeypatch, workload):
    """A traced train run on the CPU (the serve kind times its traced cases with CUDA events, so it traces on a card
    only): the trace holds ``"program"`` with each phase opened once a traced step, the breakdown keeps its two
    keys, and no per-phase metric reads (no device operation)."""
    spans.install()
    installed, seen = trace.traced, []

    def recording(run_units, device):
        out = installed(run_units, device)
        seen.append(out)
        return out

    recording.reduces_program_spans = True
    monkeypatch.setattr(trace, "traced", recording)
    bench_cell = tiny(workload)
    result = cell.run_cell(bench_cell, SEED, 0.5, True, "cpu", time.perf_counter())
    assert result["correct"] and set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    opened = {k: v["opened"] for k, v in seen[0]["program"]["spans"].items()}
    assert opened == {"train.forward": 3, "train.backward": 3, "train.update": 3}
    phase_metrics = {m["name"] for m in bench_cell.per_layer if m["source"] == "program_span"}
    assert len(phase_metrics) == 6 and not phase_metrics & set(result["metrics"])
