"""The port's package boundary: torch only, nothing built at import, CPU tensors take the plain versions."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.ops.kernels import build, prenorm_mlp, windowed_nmf

torch.set_num_threads(1)

PACKAGE = Path(ftt.__file__).parent


def test_import_leaves_jax_out():
    """In a fresh interpreter, importing the port imports neither jax nor the JAX package."""
    code = (
        "import sys, factorizer_tpu_torch, factorizer_tpu_torch.ops.kernels; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'factorizer_tpu')); "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PACKAGE.parent, timeout=120)


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")), ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_module_imports_jax(path):
    """No source file of the port names jax, flax or the JAX package in an import."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not set(roots) & {"jax", "jaxlib", "flax", "factorizer_tpu"}, (path, roots)


def test_cpu_calls_build_nothing():
    """Importing the wrappers and calling them on CPU tensors loads no kernel library."""
    code = (
        "import torch\n"
        "from factorizer_tpu_torch.ops.kernels import build, prenorm_mlp, windowed_nmf\n"
        "x = torch.rand(1, 8, 8, 8, 8)\n"
        "windowed_nmf(x, torch.rand(4, 1), torch.rand(64, 1), 4, 4, (None, 2))\n"
        "c = 32; y = torch.rand(5, c)\n"
        "prenorm_mlp(y, torch.ones(c), torch.zeros(c), torch.rand(4 * c, c), torch.zeros(4 * c),\n"
        "            torch.rand(c, 4 * c), torch.zeros(c))\n"
        "assert build._state['lib'] is None\n"
        "assert windowed_nmf.launches == 0 and prenorm_mlp.launches == 0\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PACKAGE.parent, timeout=120)


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; a tensor elsewhere that is not CUDA raises."""
    x = torch.empty(1, 8, 8, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        windowed_nmf(x, torch.empty(4, 1, device="meta"), torch.empty(64, 1, device="meta"), 4, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        p = torch.empty(32, device="meta")
        prenorm_mlp(torch.empty(5, 32, device="meta"), p, p, torch.empty(128, 32, device="meta"),
                    torch.empty(128, device="meta"), torch.empty(32, 128, device="meta"), p)


def test_reference_kernels_is_scoped():
    """reference_kernels() is off by default and restores the previous mode on exit, even on error."""
    assert build._state["reference"] is False
    with pytest.raises(RuntimeError):
        with ftt.reference_kernels():
            assert build._state["reference"] is True
            raise RuntimeError
    assert build._state["reference"] is False


def test_sources_and_build_flags():
    """The kernels compile from the package's own csrc/ for sm_90a into one shared library, no torch headers, no fast math."""
    sources = sorted(p.name for p in build.CSRC_DIR.glob("*.cu"))
    assert sources == ["mlp_block.cu", "mlp_block_bwd.cu", "windowed_nmf.cu", "windowed_nmf_bwd.cu"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in build.ARCH_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS  # flush-to-zero would change K1's gradients at zero windows
    for path in build.CSRC_DIR.iterdir():
        text = path.read_text()
        assert "torch/extension.h" not in text and "cublas" not in text.lower(), path
    assert build.BUILD_DIR.parent == PACKAGE
    entry_points = {name for path in build.CSRC_DIR.glob("*.cu") for name in build._SIGNATURES if f" {name}(" in path.read_text()}
    assert entry_points == set(build._SIGNATURES)  # every bound entry point is defined in a source


def test_entry_points_default_to_the_card():
    """device=None means the card: without one, brats23_network() raises instead of building on the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ftt.brats23_network()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ftt.resolve_device(None)
    assert ftt.resolve_device("cpu") == torch.device("cpu")


def test_cuda_tensors_never_take_the_plain_version():
    """No wrapper gives way to its plain version: the routing has no try, and the old refusals are gone."""
    for name in ("windowed_nmf.py", "mlp_block.py"):
        source = (PACKAGE / "ops" / "kernels" / name).read_text()
        assert "NotImplementedError" not in source, name
        assert not [n for n in ast.walk(ast.parse(source)) if isinstance(n, ast.Try)], name
