"""``utils/debug.py`` and ``utils/profiling.py`` of the port against their JAX counterparts' contracts, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu.utils import debug as jax_debug

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.utils import debug, profiling
from factorizer_tpu_torch.utils.weights import _flax_named_paths, flax_path

torch.set_num_threads(1)

SP = (16, 16, 16)
CONFIG = dict(in_channels=4, out_channels=3, spatial_size=SP, encoder_depth=(1, 1), encoder_width=(8, 16),
              strides=(1, 2), decoder_depth=(1,), rank=1, num_iters=3, init_method="uniform", solver="hals")
SW = {"head_dim": 4, "patch_size": 4, "shifts": [None, 2]}


@pytest.fixture(scope="module")
def models():
    model_j = ftx.Factorizer(**CONFIG, reshape=(ftx.SWMatricize, SW))
    variables = jax.tree.map(np.asarray, dict(jax.jit(model_j.init)(jax.random.key(0), jnp.zeros((1, 4, *SP)))))
    model_t = ftt.Factorizer(**CONFIG, reshape=(ftt.SWMatricize, SW), device="cpu")
    return variables, ftt.load_flax_variables(model_t, variables)


def test_debug_nans_raises_in_the_forward_and_restores_the_setting():
    """A NaN made in a forward raises at the first module that outputs it; on exit the anomaly setting is the one
    from before, and outside the block the NaN passes."""
    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Identity())
    x = torch.tensor([[float("nan"), 1.0]])
    torch.autograd.set_detect_anomaly(False)
    with debug.debug_nans():
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        with pytest.raises(FloatingPointError, match="NaN in the output of Linear"):
            model(x)
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(model(x)).any()


def test_debug_nans_raises_in_the_backward():
    """A NaN made only in a backward (sqrt's gradient at a negative input, times 0 in the forward) raises there;
    ``enable=False`` inside an enabled block turns the check off and restores it after."""
    y = torch.tensor([-1.0], requires_grad=True)
    with debug.debug_nans():
        out = torch.nan_to_num(torch.sqrt(y)) * 0
        with pytest.raises(RuntimeError, match="returned nan values"):
            out.sum().backward()
        with debug.debug_nans(False):
            assert not torch.is_anomaly_enabled()
            (torch.nan_to_num(torch.sqrt(y)) * 0).sum().backward()
            assert torch.isnan(y.grad).all()
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()


def test_assert_finite_names_the_bad_entries():
    """``FloatingPointError`` naming the first five non-finite entries of a state dict, nested ones by their path."""
    tree = {f"w{i}": torch.tensor([1.0, float("inf") if i % 2 else 0.0]) for i in range(12)}
    tree["inner"] = {"a": torch.ones(2), "b": [torch.zeros(1), torch.tensor([float("nan")])]}
    with pytest.raises(FloatingPointError, match=r"non-finite values in grads: \['w1', 'w3', 'w5', 'w7', 'w9'\]"):
        debug.assert_finite(tree, "grads")
    with pytest.raises(FloatingPointError, match=r"\['inner.b\[1\]'\]"):
        debug.assert_finite({"inner": tree["inner"]})
    debug.assert_finite({"ok": torch.ones(3), "also": [torch.zeros(2)]})


def test_tree_norms_equal_jax_tree_norms(models):
    """``tree_norms`` of the bridged state dict, f64, against JAX's ``tree_norms`` of the same variables under x64,
    entry for entry through the bridge's paths, to 1e-12."""
    variables, model_t = models
    got = debug.tree_norms(model_t.double().state_dict())
    with jax.enable_x64(True):
        want = jax_debug.tree_norms(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables))
    named = _flax_named_paths(model_t)
    assert len(got) == len(want)
    for key, norm in got.items():
        try:
            collection, path, _ = flax_path(key)
        except KeyError:
            collection, path, _ = named[key]
        jax_key = "".join(f"['{p}']" for p in (collection, *path))
        np.testing.assert_allclose(norm, want[jax_key], rtol=1e-12, err_msg=key)


def test_profile_model_counts_the_parameters_as_jax(models):
    """``profile_model``'s record: the JAX record's keys, ``params`` equal to the JAX variables' count, a positive
    FLOP count and latency, NaN bytes (torch counts none), ``backend`` the input's device type."""
    variables, model_t = models
    record = profiling.profile_model(model_t.float(), torch.zeros(1, 4, *SP), iters=1)
    assert record.keys() == {"flops", "bytes_accessed", "params", "latency_s", "input_shape", "backend"}
    assert record["params"] == sum(a.size for a in jax.tree.leaves(variables["params"]))
    assert record["flops"] > 0 and record["latency_s"] > 0 and np.isnan(record["bytes_accessed"])
    assert record["input_shape"] == [1, 4, *SP] and record["backend"] == "cpu"


def test_cost_analysis_of_a_linear_counts_2mnk():
    """One ``Linear`` of K -> N features on M rows: 2 * M * N * K floating-point operations."""
    m, k, n = 12, 7, 5
    costs = profiling.cost_analysis(torch.nn.Linear(k, n), torch.zeros(m, k))
    assert costs["flops"] == 2 * m * n * k and np.isnan(costs["bytes_accessed"])


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace(log_dir)`` writes ``trace.json`` with the block's operations; ``dump_profile`` writes a record."""
    with profiling.trace(tmp_path / "trace"):
        torch.ones(4, 4) @ torch.ones(4, 4)
    assert "aten::mm" in (tmp_path / "trace" / "trace.json").read_text()
    profiling.dump_profile({"latency_s": 1.5}, tmp_path / "record.json")
    assert '"latency_s": 1.5' in (tmp_path / "record.json").read_text()
