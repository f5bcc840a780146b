"""Port parity: the clustering layers (KMeans, FuzzyCMeans, EntropyKMeans) against the JAX package on the CPU.

Points ``(2, 3, 40, 4)`` (40 points of 4 features a batch element) from a numpy seed, 4 centers: the same initial
centers (Python's ``random.Random(seed).sample``), memberships, centers and ``loss`` in float64 to 1e-10, and the
gradient of a function of the centers under ``num_grad_steps`` to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
import factorizer_tpu_torch as ftt

torch.set_num_threads(1)

LAYERS = {
    "KMeans": {},
    "FuzzyCMeans": {"m": 2.0},
    "EntropyKMeans": {"alpha": 0.5},
}


def _x(dtype=np.float64):
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((2, 3, 4, 4)) * 3
    return (centers[..., rng.integers(0, 4, 40), :] + rng.standard_normal((2, 3, 40, 4))).astype(dtype)


@pytest.mark.parametrize("name", list(LAYERS))
def test_clustering_matches_jax(name):
    """Initial centers, memberships after 6 iterations, centers and loss: float64 to 1e-10; the one-hot memberships
    of KMeans in x's dtype."""
    kw = dict(num_centers=4, num_iters=6, seed=3, **LAYERS[name])
    m_t, m_j = getattr(ftt, name)(**kw), getattr(ftx, name)(**kw)
    with jax.enable_x64(True):
        x = _x()
        u0_t, v0_t = m_t.initialize(torch.from_numpy(x))
        u0_j, v0_j = m_j.initialize(jnp.asarray(x))
        u_t, v_t = m_t(torch.from_numpy(x))
        u_j, v_j = m_j(jnp.asarray(x))
        loss_t, loss_j = m_t.loss(torch.from_numpy(x), u_t, v_t), m_j.loss(jnp.asarray(x), u_j, v_j)
    assert u_t.dtype == torch.float64 and u_t.shape == (2, 3, 40, 4) and v_t.shape == (2, 3, 4, 4)
    for a, b in ((u0_t, u0_j), (v0_t, v0_j), (u_t, u_j), (v_t, v_j), (loss_t, loss_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)
    if name == "KMeans":
        assert set(np.unique(u_t.numpy())) <= {0.0, 1.0}
        assert m_t(torch.from_numpy(x).float())[0].dtype == torch.float32


@pytest.mark.parametrize("name", list(LAYERS))
@pytest.mark.parametrize("num_grad_steps", [None, 2])
def test_clustering_gradient_truncation_matches_jax(name, num_grad_steps):
    """``num_grad_steps``: the leading iterations see a detached x, as JAX's ``stop_gradient``; the gradient of a
    weighted sum of the centers in float64 to 1e-9."""
    kw = dict(num_centers=4, num_iters=4, num_grad_steps=num_grad_steps, seed=3, **LAYERS[name])
    m_t, m_j = getattr(ftt, name)(**kw), getattr(ftx, name)(**kw)
    w = np.random.default_rng(1).standard_normal((2, 3, 4, 4))
    with jax.enable_x64(True):
        x = _x()
        g_j = np.asarray(jax.grad(lambda x: (m_j(x)[1] * w).sum())(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        (m_t(xt)[1] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_j, rtol=1e-9, atol=1e-9 * np.abs(g_j).max())
