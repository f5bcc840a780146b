"""Port parity: the randomized SVD, the SVD layer and the SVD / NNDSVD initializers against the JAX package.

The port draws the test matrix from a CPU ``torch.Generator`` (``factorization.svd.gaussian``), the JAX package from
``jax.random.key(seed)``; here the port's draw is replaced by JAX's so that the two compute on the same numbers:
float64 to 1e-10.  Without the replacement the results agree wherever they do not depend on the draw, on matrices
of rank at most the target rank.  Also the half-precision refusal and ``infer_rank``'s pair.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.factorization import svd as svd_module

torch.set_num_threads(1)

SIZE = (8, 48)


def _jax_draw(shape, dtype, device, seed):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return torch.from_numpy(np.array(jax.random.normal(jax.random.key(seed), tuple(shape), jdt))).to(device)


@pytest.fixture
def jax_omega(monkeypatch):
    monkeypatch.setattr(svd_module, "gaussian", _jax_draw)


def _x(shape=(2, 3, *SIZE), seed=0):
    return np.random.default_rng(seed).random(shape)


@pytest.mark.parametrize("rank", [1, 3])
def test_randomized_svd_matches_jax(jax_omega, rank):
    """u, s, v each to 1e-10 in float64; and the gradient of a function of the reconstruction to 1e-8.  Rank 1 takes
    the port's closed form, whose signs are LAPACK's, so they agree too; at rank 3 the small SVD is
    ``torch.linalg.svd`` (MKL here) against JAX's LAPACK, which may pick the other sign of a singular pair: u and v
    are compared column by column up to that sign."""
    with jax.enable_x64(True):
        x = _x()
        u, s, v = (t.numpy() for t in ftt.randomized_svd(torch.from_numpy(x), rank))
        u_j, s_j, v_j = (np.asarray(t) for t in ftx.randomized_svd(jnp.asarray(x), rank))
        if rank > 1:
            sign = np.sign((u * u_j).sum(-2, keepdims=True))
            u, v = u * sign, v * sign
        for a, b in ((u, u_j), (s, s_j), (v, v_j)):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)
        m_j, m_t = ftx.SVD(SIZE, rank=rank), ftt.SVD(SIZE, rank=rank)
        w = _x(seed=5)
        g_j = np.asarray(jax.grad(lambda x: (m_j(x) * w).sum())(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        (m_t(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_j, rtol=1e-8, atol=1e-8 * np.abs(g_j).max())


def test_svd_layer_matches_jax(jax_omega):
    """``SVD``: the rank from ``compression``, ``decompose``, ``reconstruct``, ``loss`` and ``no_grad`` against JAX."""
    with jax.enable_x64(True):
        m_j, m_t = ftx.SVD(SIZE, compression=2.0, no_grad=True), ftt.SVD(SIZE, compression=2.0, no_grad=True)
        assert (m_t.rank, m_t.compression) == (m_j.rank, m_j.compression) == ftt.infer_rank(SIZE, None, 2.0)
        x = _x()
        y_j, y_t = np.asarray(m_j(jnp.asarray(x))), m_t(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(y_t, y_j, rtol=1e-10, atol=1e-12)
        u, s, v = m_t.decompose(torch.from_numpy(x))
        loss_j = m_j.loss(jnp.asarray(x), *m_j.decompose(jnp.asarray(x)))
        np.testing.assert_allclose(m_t.loss(torch.from_numpy(x), u, s, v).numpy(), np.asarray(loss_j), rtol=1e-10)
        xt = torch.from_numpy(x).requires_grad_(True)
        assert not m_t(xt).requires_grad  # no_grad detaches the decomposition


@pytest.mark.parametrize("init", ["svd", "nndsvd"])
@pytest.mark.parametrize("solver", ["mu", "hals"])
def test_svd_inits_through_matrix_factorization_match_jax(jax_omega, init, solver):
    """``init_method: svd | nndsvd`` under MU and under HALS (a projected solver: the SVD init's signs matter there)
    at rank 2, float64 to 1e-10; the initial factors themselves too.  Neither init holds a buffer."""
    with jax.enable_x64(True):
        m_j = ftx.MatrixFactorization(size=SIZE, rank=2, init_method=init, solver=solver)
        variables = m_j.init(jax.random.key(0), method=lambda m: m.initializer)
        assert "buffers" not in variables
        m_t = ftt.MatrixFactorization(SIZE, rank=2, init_method=init, solver=solver)
        assert not list(m_t.state_dict()) and isinstance(m_t.init, {"svd": ftt.SVDInit, "nndsvd": ftt.NNDSVDInit}[init])
        x = _x()
        y_j = np.asarray(m_j.apply(variables, jnp.asarray(x)))
        y_t = m_t(torch.from_numpy(x)).numpy()
        init_j = {"svd": ftx.SVDInit, "nndsvd": ftx.NNDSVDInit}[init](SIZE, rank=2)(jnp.asarray(x))
        init_t = m_t.init(torch.from_numpy(x))
    np.testing.assert_allclose(y_t, y_j, rtol=1e-10, atol=1e-12)
    for a, b in zip(init_t, init_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)
    if init == "nndsvd":
        assert all(bool((f >= 0).all()) for f in init_t)


@pytest.mark.parametrize("rank", [1, 2])
def test_low_rank_input_does_not_depend_on_the_draw(rank):
    """On matrices of rank <= R the port's own draw gives JAX's reconstruction and NNDSVD factors to
    1e-10 (float64): the range found is the matrix's range whatever the test matrix."""
    rng = np.random.default_rng(7)
    x = rng.random((3, SIZE[0], rank)) @ rng.random((3, rank, SIZE[1]))
    with jax.enable_x64(True):
        y_t = ftt.SVD(SIZE, rank=rank)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(y_t, np.asarray(ftx.SVD(SIZE, rank=rank)(jnp.asarray(x))), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(y_t, x, rtol=1e-10, atol=1e-12)
        got = ftt.NNDSVDInit(SIZE, rank=rank)(torch.from_numpy(x))
        want = ftx.NNDSVDInit(SIZE, rank=rank)(jnp.asarray(x))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_precision_raises_naming_the_dtype(dtype):
    """Half precision raises ``NotImplementedError`` naming the dtype, as JAX's QR does; a MatrixFactorization with
    an SVD init solves a half-precision input in float32 instead."""
    name = str(dtype).removeprefix("torch.")
    x = torch.from_numpy(_x((2, *SIZE))).to(dtype)
    with pytest.raises(NotImplementedError, match=f"Unsupported dtype {name}"):
        ftt.SVD(SIZE, rank=1)(x)
    with pytest.raises(NotImplementedError, match=f"Unsupported dtype {name}"):
        ftt.NNDSVDInit(SIZE, rank=1)(x)
    y = ftt.MatrixFactorization(SIZE, rank=1, init_method="nndsvd", solver="hals")(x)
    assert y.dtype == dtype and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("size,rank,compression", [((8, 512), None, 10.0), ((8, 64), None, 2.0), ((8, 64), 3, None)])
def test_infer_rank_returns_jax_s_pair(size, rank, compression):
    """``infer_rank`` is JAX's: ``(rank, achieved compression)``, and ``ValueError`` when both are None."""
    assert ftt.infer_rank(size, rank, compression) == ftx.infer_rank(size, rank, compression)
    with pytest.raises(ValueError, match="'rank' or 'compression'"):
        ftt.infer_rank(size, None, None)


def test_test_matrix_is_kept_and_made_outside_inference_mode():
    """The same arguments give the same draw, kept rather than redrawn; a draw first made while serving under
    ``inference_mode`` can be saved for a backward afterwards (a train step after a served volume)."""
    svd_module.gaussian.cache_clear()
    m = ftt.SVD((8, 40), rank=1)
    x = torch.from_numpy(_x((2, 8, 40))).float()
    with torch.inference_mode():
        served = m(x)
    draw = svd_module.gaussian((2, 40, 1), torch.float32, torch.device("cpu"), 42)
    assert draw is svd_module.gaussian((2, 40, 1), torch.float32, torch.device("cpu"), 42)
    assert not draw.is_inference()
    xt = x.clone().requires_grad_(True)
    y = m(xt)
    y.sum().backward()
    assert torch.equal(y.detach(), served) and bool(torch.isfinite(xt.grad).all())
