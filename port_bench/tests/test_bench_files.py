"""Every file the benchmark finds by name is there and parses, and BENCHMARK.json keeps to its own rules."""

from __future__ import annotations

import json
import re

import pytest
import yaml

from port_bench.bench import spec

from .conftest import DATA, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|width|hidden|intermediate|latent|state|proj|head|ratio|expansion")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1 and len(w["why"]) <= 200
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_bundles(config):
    """The configuration file holds the bundle's network_def and training settings unedited, and reduces no width."""
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    cfg = json.loads((ROOT / config["file"]).read_text())
    bundle = yaml.safe_load((ROOT / cfg["bundle"]).read_text())
    assert cfg["network_def"] == bundle["network_def"]
    for key in ("seed", "roi_size", "batch_size", "learning_rate", "weight_decay", "amp", "remat"):
        assert cfg[key] == bundle[key], key
    assert cfg["reduced"] == config["reduced"] == []
    assert not any(WIDTH.search(k) for k in config["reduced"])
    assert cfg["precision"] == {"dtype": "float32", "tf32": False, "control": {"dtype": "float32", "tf32": True}}
    assert spec.load_reference(cfg).param_spec(cfg["network_def"], cfg["roi_size"])


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(workload):
    cell = spec.load_cell(workload["name"])
    kind = spec.load_kind(cell.traffic["kind"])
    assert callable(kind.run) and callable(kind.readings)
    numbers = ({"loss_gap", "loss_gap_first", "grad_gap", "change_gap", "change_gap_median"} if cell.traffic["kind"] == "train"
               else {"probs_gap", "mask_gap"})
    assert cell.limits and set(cell.limits) <= numbers
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_declares_what_benchmark_says(metric):
    module = spec.load_metric(metric["name"])
    assert callable(module.read)
    assert (module.UNIT, module.BETTER, module.SOURCE) == (metric["unit"], metric["better"], metric["source"])
    if "layer" in metric:
        assert module.LAYER == metric["layer"] and module.MOVES == metric["moves"]
    if getattr(module, "KERNEL", None):  # a roofline names its kernel's file: counters, device names, work
        kernel = spec.load_kernel(module.KERNEL)
        assert kernel.COUNTERS and re.compile(kernel.NAMES) and callable(kernel.work)


def test_metrics_of_one_layer_share_its_name():
    by_file = {}
    for m in BENCH["per_layer"]:
        by_file.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(layers) == 1 for layers in by_file.values())


@pytest.mark.parametrize("path", sorted((DATA / "traffic").glob("*.json")) + sorted((ROOT / "port_bench" / "traffic").glob("*.json")),
                         ids=lambda p: p.name)
def test_traffic_files_parse(path):
    mix = json.loads(path.read_text())
    assert (spec.BENCH_DIR / "kinds" / f"{mix['kind']}.py").exists()


def test_paths_hold_the_benchmark_alone():
    """Every file the command and the configs name lies under paths."""
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/")
        assert json.loads((ROOT / c["file"]).read_text())["reference"].startswith("port_bench/reference/")
    assert all(not p.startswith("/") and ".." not in p for p in BENCH["paths"] + BENCH["command"])
