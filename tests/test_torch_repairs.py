"""Port parity where the port once departed from the JAX package: the factorization's default solver, the
sliding window's blending options, and the evaluation step over a mesh that a batch does not split over.

The evaluation workers are spawned processes that import this module, so jax is imported inside the tests
that need it, never at the top.
"""

import numpy as np
import pytest
import torch

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.parallel import data_parallel_mesh, initialize_distributed, run_processes
from factorizer_tpu_torch.train import sliding_window as sw_torch
from factorizer_tpu_torch.train import trainer

torch.set_num_threads(1)

SIZE = (8, 64)


def _mf_pair(**kw):
    """A JAX MatrixFactorization and the port's, holding the same u0 / v0 tables, in float64."""
    import jax
    import jax.numpy as jnp

    import factorizer_tpu as ftx

    m_j = ftx.MatrixFactorization(size=SIZE, **kw)
    variables = m_j.init(jax.random.key(0), jnp.zeros((1, *SIZE), jnp.float64))
    m_t = ftt.MatrixFactorization(SIZE, **kw)
    init = variables["buffers"]["initializer"]
    m_t.init.u0 = torch.tensor(np.asarray(init["u0"]))
    m_t.init.v0 = torch.tensor(np.asarray(init["v0"]))
    return m_j, variables, m_t


@pytest.mark.parametrize("kw", [{}, {"solver": "cd", "rank": 2}], ids=["defaults", "cd-rank2"])
def test_matrix_factorization_default_solver_matches_jax(kw):
    """Default arguments take JAX's solver, coordinate descent without a projection ("cd"), whose factors go
    negative on a signed input; "cd" by name at rank 2 too.  f64, 1e-10."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        m_j, variables, m_t = _mf_pair(**kw)
        assert m_t.solver == "cd"
        x = np.random.default_rng(0).standard_normal((3, *SIZE))
        y_j = np.asarray(m_j.apply(variables, jnp.asarray(x)))
        y_t = m_t(torch.from_numpy(x)).detach().numpy()
    assert y_t.dtype == np.float64 and (y_t < 0).any()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mode,sigma_scale", [("constant", 0.125), ("gaussian", 0.3)])
def test_importance_map_options_match_jax(mode, sigma_scale):
    from factorizer_tpu.train import sliding_window as sw_jax

    roi = (16, 12, 8)
    np.testing.assert_array_equal(sw_torch.compute_importance_map(roi, mode, sigma_scale),
                                  sw_jax.compute_importance_map(roi, mode, sigma_scale))


@pytest.mark.parametrize("mode", ["constant", "gaussian"])
def test_inference_mode_and_pad_value_match_jax(mode):
    """A volume smaller than the roi, padded with 1.0 (the predictor sees the pad), blended in ``mode``."""
    import jax.numpy as jnp

    from factorizer_tpu.train import sliding_window as sw_jax

    w = np.random.default_rng(3).standard_normal((3, 2)).astype(np.float32)

    def predict_jax(windows):
        return jnp.tanh(jnp.einsum("oc,nc...->no...", w, windows) * windows.mean(axis=(1, 2, 3, 4), keepdims=True))

    def predict_torch(windows):
        return torch.tanh(torch.einsum("oc,nc...->no...", torch.from_numpy(w), windows)
                          * windows.mean(dim=(1, 2, 3, 4), keepdim=True))

    x = np.random.default_rng(4).standard_normal((1, 2, 6, 18, 5)).astype(np.float32)
    kw = dict(sw_batch_size=3, overlap=0.5, mode=mode, pad_value=1.0)
    y_j = sw_jax.sliding_window_inference(jnp.asarray(x), (8, 8, 8), predict_jax, **kw)
    y_t = sw_torch.sliding_window_inference(torch.from_numpy(x), (8, 8, 8), predict_torch, **kw)
    zero_pad = sw_torch.sliding_window_inference(torch.from_numpy(x), (8, 8, 8), predict_torch, sw_batch_size=3,
                                                 overlap=0.5, mode=mode)
    assert y_t.shape == (1, 3, 6, 18, 5)
    assert not torch.allclose(y_t, zero_pad)  # the pad value reaches the predictions
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6, atol=1e-6)


SP = (16, 16, 16)
CONFIG = dict(  # the reduced Factorizer of tests/test_torch_parallel.py
    in_channels=4, out_channels=3, spatial_size=SP, encoder_depth=(1, 1, 1), encoder_width=(8, 16, 16),
    strides=(1, 2, 2), decoder_depth=(1, 1), mlp_ratio=4, act="relu", rank=1, num_iters=5, init_method="uniform",
    solver="hals",
)
SW = {"head_dim": 4, "patch_size": 4, "shifts": [None, 1, 2, 3]}
EVAL_BATCHES = (1, 3, 2)


def _model():
    return ftt.Factorizer(**CONFIG, reshape=(ftt.SWMatricize, SW), device="cpu", generator=torch.Generator().manual_seed(1))


def _images(b):
    return torch.from_numpy(np.random.default_rng(b).standard_normal((b, 4, *SP)).astype(np.float32))


def _eval_worker(rank, world, init_method):
    """``make_eval_step(model, mesh=)`` on batches that do (2) and do not (1, 3) split over two processes."""
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    step = trainer.make_eval_step(_model(), mesh=data_parallel_mesh())
    return [step(_images(b)) for b in EVAL_BATCHES]


def test_eval_step_over_a_mesh_takes_any_batch():
    """Two gloo processes: every process gets the one-process logits of the whole batch, whether the batch
    splits over the data axis (2) or not (1, 3)."""
    model = _model().eval()
    with torch.no_grad():
        expected = [model(_images(b)) for b in EVAL_BATCHES]
    for logits in run_processes(_eval_worker, 2, timeout=180):
        for got, want, b in zip(logits, expected, EVAL_BATCHES):
            assert got.shape == (b, 3, *SP)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
