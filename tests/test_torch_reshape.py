"""Port parity: Matricize / SWMatricize against the JAX reshapes (exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
import factorizer_tpu_torch as ftt

torch.set_num_threads(1)

CASES = [
    # (channels-last input size, kwargs)
    ((2, 8, 8, 8, 16), {"head_dim": 8, "patch_size": 4}),
    ((2, 8, 8, 8, 16), {"head_dim": 4, "patch_size": 4, "shifts": 2}),
    ((1, 16, 8, 8, 4), {"num_heads": 2, "grid_size": (2, 1, 2), "shifts": (1, 2, 3)}),
    ((2, 8, 8, 16, 8), {"head_dim": 4, "patch_size": 4, "shifts": (1, 0, 2)}),
    ((2, 6, 12, 8), {"num_heads": 1, "patch_size": (3, 4)}),
]


@pytest.mark.parametrize("size,kw", CASES)
def test_matricize_matches_jax(size, kw):
    """Forward and inverse are bit-identical to JAX (pure permutations); tolerance 0."""
    x = np.random.default_rng(0).standard_normal(size).astype(np.float32)
    m_j = ftx.Matricize(size, data_format="channels_last", **kw)
    m_t = ftt.Matricize(size, **kw)
    assert m_t.output_size == m_j.output_size
    y_j = np.asarray(m_j(jnp.asarray(x)))
    y_t = m_t(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(m_t.inverse_forward(torch.tensor(y_j)).numpy(), x)


@pytest.mark.parametrize("shifts", [None, [None, 2, 4, 6], [None, (1, 2, 3)]])
def test_swmatricize_matches_jax(shifts):
    """Concatenated per-shift folds are identical; the averaged inverse agrees to f32 rounding (1e-6)."""
    size = (2, 16, 16, 16, 16)
    kw = dict(head_dim=8, patch_size=8, shifts=shifts)
    x = np.random.default_rng(1).standard_normal(size).astype(np.float32)
    sw_j, sw_t = ftx.SWMatricize(size, data_format="channels_last", **kw), ftt.SWMatricize(size, **kw)
    y_j = np.asarray(sw_j(jnp.asarray(x)))
    y_t = sw_t(torch.from_numpy(x))
    np.testing.assert_array_equal(y_t.numpy(), y_j)
    z = np.random.default_rng(2).standard_normal(y_j.shape).astype(np.float32)
    np.testing.assert_allclose(
        sw_t.inverse_forward(torch.from_numpy(z)).numpy(),
        np.asarray(sw_j.inverse_forward(jnp.asarray(z))),
        rtol=0, atol=1e-6,
    )
    np.testing.assert_allclose(sw_t.inverse_forward(y_t).numpy(), x, rtol=0, atol=1e-6)
