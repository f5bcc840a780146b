"""Port parity: the four positional embeddings, ``dot`` / ``softmax`` / ``kl_divergence`` and channels-first
``Matricize`` against the JAX package on the CPU.

The learnable tables (``pos``, the axial ``pe{i}``) go from the JAX variables to the port's channels-first layout as
the weight bridge moves them; each embedding adds to a channels-last ``(2, 4, 6, 8, 16)`` input in float64 to 1e-10.
``rows=`` on a slab of the first spatial axis equals that slab of the whole volume's output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
import factorizer_tpu_torch as ftt

torch.set_num_threads(1)

SPATIAL, C = (4, 6, 8), 16
EMBEDDINGS = ["SinusoidalPositionalEmbedding", "RotaryPositionalEmbedding", "PositionalEmbedding",
              "AxialPositionalEmbedding"]


def _pair(name):
    """The JAX embedding with its variables, and the port's holding the same tables."""
    m_j = getattr(ftx, name)(C, SPATIAL)
    variables = m_j.init(jax.random.key(0), jnp.zeros((1, *SPATIAL, C)))
    m_t = getattr(ftt, name)(C, SPATIAL, device="cpu")
    params = variables.get("params", {})
    assert sorted(params) == sorted(k for k, _ in m_t.named_parameters())
    for key, value in params.items():
        getattr(m_t, key).data.copy_(torch.from_numpy(np.moveaxis(np.asarray(value), -1, 1).copy()))
    assert not m_t.state_dict().keys() - params.keys()  # the fixed tables stay out of the state_dict
    return m_j, variables, m_t


@pytest.mark.parametrize("name", EMBEDDINGS)
def test_embedding_matches_jax(name):
    """float64 to 1e-10 and float32 to 1e-6; a slab's rows (``rows=slice(2, 4)``) give that slab of the whole output."""
    m_j, variables, m_t = _pair(name)
    x = np.random.default_rng(0).standard_normal((2, *SPATIAL, C))
    with jax.enable_x64(True):
        y_j = np.asarray(m_j.apply(variables, jnp.asarray(x)))
        y_t = m_t(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-10, atol=1e-12)
    y32 = m_t(torch.from_numpy(x).float()).detach()
    assert y32.dtype == torch.float32
    np.testing.assert_allclose(y32.numpy(), np.asarray(m_j.apply(variables, jnp.asarray(x, jnp.float32))), rtol=1e-6,
                               atol=1e-5)
    slab = m_t(torch.from_numpy(x[:, 2:4]), slice(2, 4)).detach().numpy()
    np.testing.assert_array_equal(slab, y_t[:, 2:4])


def test_pos_embed_alias_and_axial_layout():
    """``PosEmbed`` is ``PositionalEmbedding``; the axial tables are ``(1, C, S_i at axis i, 1 elsewhere)``."""
    assert ftt.PosEmbed is ftt.PositionalEmbedding
    shapes = {k: tuple(p.shape) for k, p in ftt.AxialPositionalEmbedding(C, SPATIAL, device="cpu").named_parameters()}
    assert shapes == {"pe0": (1, C, 4, 1, 1), "pe1": (1, C, 1, 6, 1), "pe2": (1, C, 1, 1, 8)}


def test_math_matches_jax():
    """``dot``, ``softmax`` over one axis and over several, ``kl_divergence``: float64 to 1e-12."""
    rng = np.random.default_rng(1)
    x, y = rng.random((3, 5, 7)), rng.random((3, 5, 7))
    with jax.enable_x64(True):
        pairs = [
            (ftt.dot(torch.from_numpy(x), torch.from_numpy(y)), ftx.dot(jnp.asarray(x), jnp.asarray(y))),
            (ftt.softmax(torch.from_numpy(x), -1), ftx.softmax(jnp.asarray(x), -1)),
            (ftt.softmax(torch.from_numpy(x), (1, -1)), ftx.softmax(jnp.asarray(x), (1, -1))),
            (ftt.kl_divergence(torch.from_numpy(x), torch.from_numpy(y)), ftx.kl_divergence(jnp.asarray(x), jnp.asarray(y))),
        ]
        for got, want in pairs:
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
    assert torch.allclose(ftt.softmax(torch.from_numpy(x), (1, 2)).sum((1, 2)), torch.ones(3, dtype=torch.float64))


@pytest.mark.parametrize("shifts", [None, 2, [(1, 2, 3)]])
def test_channels_first_matricize_matches_jax(shifts):
    """``data_format="channels_first"``: ``(B, C, *S)`` folds to the JAX package's matrices (its default layout)
    exactly, and the inverse restores the input exactly; ``SWMatricize`` likewise, with the shifts per copy."""
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 4, 8)).astype(np.float32)
    kw = dict(head_dim=4, patch_size=(4, 2, 4))
    if isinstance(shifts, list):
        m_t = ftt.SWMatricize(x.shape, shifts=[None, *shifts], data_format="channels_first", **kw)
        m_j = ftx.SWMatricize(x.shape, shifts=[None, *shifts], **kw)
    else:
        m_t = ftt.Matricize(x.shape, shifts=shifts, data_format="channels_first", **kw)
        m_j = ftx.Matricize(x.shape, shifts=shifts, **kw)
    folded = m_t(torch.from_numpy(x))
    assert tuple(folded.shape) == tuple(np.asarray(m_j(jnp.asarray(x))).shape)
    np.testing.assert_array_equal(folded.numpy(), np.asarray(m_j(jnp.asarray(x))))
    np.testing.assert_array_equal(m_t.inverse_forward(folded).numpy(), x)
    assert m_t.output_size == m_j.output_size
    with pytest.raises(ValueError, match="data_format"):
        ftt.Matricize(x.shape, data_format="channels_middle", **kw)
