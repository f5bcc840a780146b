"""The port's package boundary: torch only, nothing built at import, CPU tensors take the plain versions."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.ops.kernels import build, depthwise_conv, depthwise_conv_dw, nmf_reconstruct, prenorm_mlp, windowed_nmf

torch.set_num_threads(1)

PACKAGE = Path(ftt.__file__).parent


def test_import_leaves_jax_out():
    """In a fresh interpreter, importing the port imports neither jax nor the JAX package."""
    code = (
        "import sys, factorizer_tpu_torch, factorizer_tpu_torch.ops.kernels, factorizer_tpu_torch.parallel.launch, "
        "factorizer_tpu_torch.ops.kernels.windowed_sharded; "
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
        "from factorizer_tpu_torch.ops.kernels import build, depthwise_conv, depthwise_conv_dw, nmf_reconstruct, prenorm_mlp, windowed_nmf\n"
        "from factorizer_tpu_torch.ops.kernels import windowed_nmf_factors, windowed_nmf_reconstruct\n"
        "x = torch.rand(1, 8, 8, 8, 8)\n"
        "nmf_reconstruct(x, torch.rand(8, 2), torch.rand(8, 2)); assert nmf_reconstruct.launches == 0\n"
        "depthwise_conv(x, torch.rand(1, 27, 8), (3, 3, 3)); depthwise_conv_dw(x, x, (3, 3, 3))\n"
        "windowed_nmf(x, torch.rand(4, 1), torch.rand(64, 1), 4, 4, (None, 2))\n"
        "from factorizer_tpu_torch.ops.kernels import windowed_nmf_multi_spatial as k5, windowed_nmf_multi_spatial_local\n"
        "windowed_nmf_multi_spatial_local([x[:, :4].contiguous(), x[:, 4:].contiguous()], torch.rand(4, 1), torch.rand(64, 1), 4, 4, (None, 2))\n"
        "assert (k5.launches, k5.backward_launches, k5.tail_launches) == (0, 0, 0) and k5.bytes_sent > 0\n"
        "c = 32; y = torch.rand(5, c)\n"
        "prenorm_mlp(y, torch.ones(c), torch.zeros(c), torch.rand(4 * c, c), torch.zeros(4 * c),\n"
        "            torch.rand(c, 4 * c), torch.zeros(c))\n"
        "assert build._state['lib'] is None\n"
        "assert windowed_nmf_factors.launches == windowed_nmf_reconstruct.launches == prenorm_mlp.launches == 0\n"
        "assert depthwise_conv.launches == 0 and depthwise_conv_dw.launches == 0\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PACKAGE.parent, timeout=120)


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; a tensor elsewhere that is not CUDA raises."""
    x = torch.empty(1, 8, 8, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        windowed_nmf(x, torch.empty(4, 1, device="meta"), torch.empty(64, 1, device="meta"), 4, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        nmf_reconstruct(x, torch.empty(8, 1, device="meta"), torch.empty(8, 1, device="meta"))
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
    assert sources == ["depthwise_conv.cu", "depthwise_conv_dw.cu", "mlp_block.cu", "mlp_block_bwd.cu",
                       "nmf.cu", "nmf_bwd.cu", "windowed_nmf.cu", "windowed_nmf_bwd.cu", "windowed_nmf_slab.cu",
                       "windowed_nmf_slab_bwd.cu"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in build.ARCH_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS  # flush-to-zero would change K1's gradients at zero windows
    for path in build.CSRC_DIR.iterdir():
        text = path.read_text()
        assert "torch/extension.h" not in text and "cublas" not in text.lower(), path
    assert build.BUILD_DIR.parent == PACKAGE
    entry_points = {name for path in build.CSRC_DIR.glob("*.cu") for name in build._SIGNATURES if f" {name}(" in path.read_text()}
    assert entry_points == set(build._SIGNATURES)  # every bound entry point is defined in a source


def test_entry_points_default_to_the_card():
    """device=None means the card: without one, the bundle factories raise instead of building on the CPU."""
    assert not torch.cuda.is_available()
    for factory in (ftt.brats23_network, ftt.factorizer_isles22_network, ftt.deconver_brats23_network,
                    ftt.deconver_isles22_network, ftt.deconver_fives_network):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            factory()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ftt.resolve_device(None)
    assert ftt.resolve_device("cpu") == torch.device("cpu")


def test_cuda_tensors_never_take_the_plain_version():
    """No wrapper gives way to its plain version: the routing has no try, and the old refusals are gone."""
    for name in ("windowed_nmf.py", "mlp_block.py", "depthwise_conv.py", "nmf.py", "windowed_sharded.py"):
        source = (PACKAGE / "ops" / "kernels" / name).read_text()
        assert "NotImplementedError" not in source, name
        assert not [n for n in ast.walk(ast.parse(source)) if isinstance(n, ast.Try)], name


def test_depthwise_kernels_stay_off_the_libraries():
    """On a CUDA tensor K3's wrappers reach no convolution of torch's: ``F.conv*`` appears in the plain version alone,
    and the Deconv layer sends every depthwise "same" convolution to the wrapper."""
    tree = ast.parse((PACKAGE / "ops" / "kernels" / "depthwise_conv.py").read_text())
    users = {
        fn.name
        for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
        for node in ast.walk(fn)
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id == "F"
    }
    assert users == {"depthwise_conv_plain"}
    source = (PACKAGE / "ops" / "kernels" / "depthwise_conv.py").read_text()
    assert "torch.compile" not in source and "cudnn" not in source.lower()
    assert depthwise_conv.launches == 0 and depthwise_conv_dw.launches == 0


def test_slab_kernels_stay_off_torch_arithmetic():
    """On a CUDA tensor K5 reaches no concatenation, roll, fold or product of torch's: ``torch.cat`` appears in the
    plain versions alone, the other names nowhere; and the port's packaging finds the new sub-package."""
    tree = ast.parse((PACKAGE / "ops" / "kernels" / "windowed_sharded.py").read_text())
    users = {
        (fn.name, node.attr)
        for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
        for node in ast.walk(fn)
        if isinstance(node, ast.Attribute) and node.attr in ("cat", "roll", "matmul", "einsum", "stack", "reshape", "permute")
    }
    assert users == {("_padded", "cat"), ("windowed_nmf_multi_spatial_plain", "cat"), ("_launch", "reshape")}
    import setuptools

    found = setuptools.find_packages(str(PACKAGE.parent), include=["factorizer_tpu*", "factorizer_tpu_torch*"])
    assert "factorizer_tpu_torch.parallel" in found and "factorizer_tpu_torch.parallel" in (PACKAGE.parent / "pyproject.toml").read_text()


@pytest.mark.parametrize("factory,kernel_size,in_out", [
    (ftt.deconver_brats23_network, (3, 3, 3), (4, 3)),
    (ftt.deconver_fives_network, (7, 7), (3, 1)),
])
def test_deconver_bundle_factories(factory, kernel_size, in_out):
    """The Deconver bundles' networks as their train.yaml has them: full width and depth, depthwise, one update,
    InstanceNorm without parameters (built on ``meta``: no memory, no arithmetic)."""
    model = factory(device="meta")
    blocks = [m for m in model.modules() if isinstance(m, ftt.DeconverBlock)]
    assert len(blocks) == 9
    assert [b.dcm.deconv.channels for b in blocks] == [32, 64, 128, 256, 512, 256, 128, 64, 32]
    for b in blocks:
        d = b.dcm.deconv
        assert (d.groups, d.source_channels, d.kernel_size, d.num_iters, d.num_grad_iters) == (d.channels, 1, kernel_size, 1, None)
        assert isinstance(b.norm1, ftt.InstanceNorm) and not list(b.norm1.parameters())
        assert b.mlp.fc1.linear.out_features == 4 * d.channels
    assert (model.stem.weight.shape[1], model.head.weight.shape[0]) == in_out
    assert model.stem.weight.ndim == 2 + len(kernel_size)
