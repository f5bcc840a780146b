"""The command without a card, and what the command and the reference import."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "factorizer_tpu"}


def _modules_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after ``code``."""
    probe = f"{code}\nimport json, sys\nprint(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_fails_without_a_card():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "factorizer_brats23.train", "--seed",
                          str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_command_imports_no_jax_nor_the_jax_package():
    """Everything the command loads, compared by whole top-level names (``factorizer_tpu_torch`` begins with the
    JAX package's name and is allowed)."""
    loaded = _modules_after("import runpy, sys; sys.argv = ['run.py']\n"
                            "sys.path.insert(0, 'port_bench')\n"
                            "import run\n"
                            "from port_bench.bench import cell, program, spec, readings, flops\n"
                            "bench = json.load(open('BENCHMARK.json'))\n"
                            "[spec.load_metric(m['name']) for m in bench['end_to_end'] + bench['per_layer']]\n"
                            "[spec.load_reference(json.load(open(c['file']))) for c in bench['configs']]\n"
                            "[spec.load_kind(json.load(open(f'port_bench/traffic/{w[\"traffic\"]}.json'))['kind'])"
                            " for w in bench['workloads']]\n"
                            "import glob, pathlib\n"
                            "[spec.load_kernel(pathlib.Path(p).stem) for p in glob.glob('port_bench/kernels/*.py')]"
                            .replace("import runpy, sys", "import json, runpy, sys"))
    assert "factorizer_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


@pytest.mark.parametrize("module", ["port_bench.reference.unet", "port_bench.reference.factorizer",
                                    "port_bench.reference.deconver", "port_bench.reference.train",
                                    "port_bench.reference.serve", "port_bench.bench.flops"])
def test_reference_imports_nothing_of_the_program(module):
    loaded = _modules_after(f"import {module}")
    assert "factorizer_tpu_torch" not in loaded and not loaded & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from port_bench.bench import cell

    monkeypatch.setitem(sys.modules, "factorizer_tpu_torch_probe", object())
    assert "factorizer_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert "flax" in cell.forbidden_modules()
