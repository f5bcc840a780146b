"""Shared fixtures of the benchmark's tests.

Tests that need a CUDA card carry the ``card`` marker and take the ``card`` fixture, which skips them where there
is none; whether there is one is decided inside the fixture, never while a module is imported.  Run them on the
card with

    python3 -m pytest port_bench/tests -m card
"""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


def merged(base: dict, changes: dict) -> dict:
    """``base`` with the keys of ``changes`` put in, nested dicts key by key."""
    out = copy.deepcopy(base)
    for k, v in changes.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else copy.deepcopy(v)
    return out


def tiny_config(config: dict) -> dict:
    """A configuration of ``BENCHMARK.json`` cut as ``data/configs/<name>.json`` says, or else ``tiny.json``."""
    own = DATA / "configs" / f"{config['name']}.json"
    changes = json.loads((own if own.exists() else DATA / "configs" / "tiny.json").read_text())
    changes.pop("why", None)
    return merged(json.loads((ROOT / config["file"]).read_text()), changes)


def tiny_benchmark(folder: Path) -> dict:
    """``BENCHMARK.json`` with its configurations cut to a CPU's size (written to ``folder``), and only the cells that
    ``data/traffic`` and ``data/limits`` hold files for; every metric and bound as it stands."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for config in bench["configs"]:
        path = folder / f"{config['name']}.json"
        path.write_text(json.dumps(tiny_config(config)))
        config["file"] = str(path)
    bench["workloads"] = [w for w in bench["workloads"] if (DATA / "traffic" / f"{w['traffic']}.json").exists()
                          and (DATA / "limits" / f"{w['name']}.json").exists()]
    return bench


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """The cells of ``BENCHMARK.json`` at a CPU's size: each configuration cut to three levels at roi 32^3, the
    traffic and limits of ``data/``."""
    from port_bench.bench import spec

    bench = tiny_benchmark(tmp_path_factory.mktemp("tiny_configs"))

    def load(workload: str):
        return spec.load_cell(workload, bench, DATA)

    load.benchmark = bench
    return load
