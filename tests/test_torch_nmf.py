"""Port parity: hals / mu NMF against the JAX NMF module (XLA path on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
import factorizer_tpu_torch as ftt

torch.set_num_threads(1)

SIZE = (8, 64)


def _pair(solver, rank, num_iters=5, num_grad_steps=None):
    """A JAX NMF, its variables, and a port NMF holding the same u0/v0 tables."""
    kw = dict(rank=rank, num_iters=num_iters, num_grad_steps=num_grad_steps, init_method="uniform", solver=solver)
    m_j = ftx.NMF(size=SIZE, **kw)
    variables = m_j.init(jax.random.key(0), jnp.zeros((1, *SIZE)))
    m_t = ftt.NMF(SIZE, **kw)
    init = variables["buffers"]["initializer"]
    m_t.init.u0.copy_(torch.tensor(np.asarray(init["u0"])))
    m_t.init.v0.copy_(torch.tensor(np.asarray(init["v0"])))
    return m_j, variables, m_t


def _x(dtype=np.float32):
    return np.random.default_rng(0).random((3, 5, *SIZE)).astype(dtype)


@pytest.mark.parametrize("solver,rank", [("hals", 1), ("mu", 1), ("hals", 2), ("mu", 3)])
def test_nmf_f32_matches_jax(solver, rank):
    """float32: same math in another summation order; rtol 1e-4, atol 1e-5."""
    m_j, variables, m_t = _pair(solver, rank)
    x = _x()
    y_j = np.asarray(m_j.apply(variables, jnp.asarray(x)))
    y_t = m_t(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("solver,rank", [("hals", 1), ("mu", 1), ("hals", 2)])
def test_nmf_f64_matches_jax(solver, rank):
    """float64 is the semantic check: forward to 1e-10 relative."""
    with jax.enable_x64(True):
        m_j, variables, m_t = _pair(solver, rank)
        x = _x(np.float64)
        y_j = np.asarray(m_j.apply(variables, jnp.asarray(x)))
        y_t = m_t(torch.from_numpy(x)).detach().numpy()
    assert y_t.dtype == np.float64
    np.testing.assert_allclose(y_t, y_j, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("num_grad_steps", [None, 2, 0])
def test_nmf_gradient_truncation_matches_jax(num_grad_steps):
    """num_grad_steps: the leading iterations see a detached x, as JAX's stop_gradient; f64, 1e-9."""
    with jax.enable_x64(True):
        m_j, variables, m_t = _pair("hals", 1, num_iters=4, num_grad_steps=num_grad_steps)
        x = _x(np.float64)
        g_j = np.asarray(jax.grad(lambda x: (m_j.apply(variables, x) ** 2).sum())(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        y = m_t(xt)
        if y.requires_grad:
            (y**2).sum().backward()
            g_t = xt.grad.numpy()
        else:
            g_t = np.zeros_like(x)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-9, atol=1e-12)


def test_nmf_bf16_solves_in_f32():
    """bf16 input: the solve runs in f32 and the result is cast back, as in JAX (bf16 rounding, 2e-2)."""
    m_j, variables, m_t = _pair("hals", 1)
    x = _x()
    y_t = m_t(torch.from_numpy(x).bfloat16())
    assert y_t.dtype == torch.bfloat16
    y_j = np.asarray(m_j.apply(variables, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_allclose(y_t.float().numpy(), y_j, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("size,rank,compression", [((8, 64), None, 10.0), ((8, 512), None, 2.0), ((8, 64), 3, 10.0)])
def test_auto_rank_matches_jax(size, rank, compression):
    """rank=None takes the auto-rank rule ceil(MN / (compression (M+N))); infer_rank returns the pair
    (rank, achieved compression) as JAX's infer_rank does, and the module keeps both as rank_ / compression_."""
    from factorizer_tpu.factorization.svd import infer_rank as infer_rank_jax

    want = infer_rank_jax(size, rank, compression)
    assert ftt.factorization.infer_rank(size, rank, compression) == want
    m = ftt.NMF(size, rank=rank, compression=compression)
    assert (m.rank_, m.compression_) == want
