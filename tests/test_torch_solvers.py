"""Port parity: every solver of the factorization engine against the JAX package's MatrixFactorization on the CPU.

Each registry name of ``SOLVER_DISPATCH_MAP`` runs through ``MatrixFactorization`` from the same ``RandomInit``
tables in both packages: float64 to 1e-10, float32 within a stated band.  Then ``Compose`` and ``parse_solver``,
``WeightedMultiplicativeUpdate`` with a weight, a projection given as a function or a factory, ``LeastSquares``'s
``pinv`` cut-off, and the gradient truncation of ``num_grad_steps``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.factorization.solvers import _pinv, _resolve_project

torch.set_num_threads(1)

SIZE = (8, 24)


def _pair(rank=2, size=SIZE, solver_t=None, **kw):
    """A JAX MatrixFactorization, its variables, and the port's holding the same u0 / v0 tables."""
    m_j = ftx.MatrixFactorization(size=size, rank=rank, init_method="uniform", **kw)
    variables = _tables(m_j)
    if solver_t is not None:
        kw = {**kw, "solver": solver_t}
    m_t = ftt.MatrixFactorization(size, rank=rank, init_method="uniform", **kw)
    tables = variables["buffers"]["initializer"]
    m_t.init.u0.copy_(torch.tensor(np.asarray(tables["u0"])))
    m_t.init.v0.copy_(torch.tensor(np.asarray(tables["v0"])))
    return m_j, variables, m_t


def _tables(m_j):
    """The JAX module's variables, its ``RandomInit`` tables alone (made without running a forward)."""
    return m_j.init(jax.random.key(0), method=lambda m: m.initializer.tables())


def _x(dtype, shape=(3, *SIZE), seed=0):
    return np.random.default_rng(seed).random(shape).astype(dtype)


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / np.abs(np.asarray(b)).max())


def test_registry_names_match_jax():
    """The 27 names, each to the same class and options (relu for relu); ``wmu-0`` / ``wmu-1`` are the plain MU."""
    assert sorted(ftt.SOLVER_DISPATCH_MAP) == sorted(ftx.SOLVER_DISPATCH_MAP) and len(ftt.SOLVER_DISPATCH_MAP) == 27
    for name, spec in ftt.SOLVER_DISPATCH_MAP.items():
        spec_j = ftx.SOLVER_DISPATCH_MAP[name]
        (cls, kw), (cls_j, kw_j) = [s if isinstance(s, tuple) else (s, {}) for s in (spec, spec_j)]
        assert cls.__name__ == cls_j.__name__ and kw.keys() == kw_j.keys(), name
        assert all(kw[k] is torch.relu if k == "project" else kw[k] == kw_j[k] for k in kw), name
    assert ftt.SOLVER_DISPATCH_MAP["wmu-1"] == (ftt.MultiplicativeUpdate, {"factor": 1})


@pytest.mark.parametrize("solver", sorted(ftx.SOLVER_DISPATCH_MAP))
def test_solver_matches_jax(solver):
    """Five iterations at rank 2 from the same tables: float64 to 1e-10; the port in float32 within 2e-4 of the
    largest entry of JAX's float64 result (``ls`` / ``nnls`` solve a 2 x 2 system or apply a pseudo-inverse)."""
    with jax.enable_x64(True):
        m_j, variables, m_t = _pair(solver=solver)
        x = _x(np.float64)
        y_j = np.asarray(m_j.apply(variables, jnp.asarray(x)))
        y_t = m_t(torch.from_numpy(x)).detach().numpy()
    assert y_t.dtype == np.float64 and np.isfinite(y_t).all()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-10, atol=1e-10 * np.abs(y_j).max())
    y32 = m_t(torch.from_numpy(x).float()).detach()
    assert y32.dtype == torch.float32 and _rel(y32.numpy(), y_j) <= 2e-4, solver


def test_compose_and_parse_solver_match_jax():
    """A list of names is a ``Compose``; ``["hals-0", "mu-1"]`` and ``[nncd, (MultiplicativeUpdate, {"factor": 1})]``
    against the JAX package's, float64 to 1e-10; indexing and length as JAX's."""
    spec = ftt.parse_solver(["hals-0", "mu-1"])
    assert spec[0] is ftt.Compose and len(spec[1]["solvers"]) == 2
    composed = ftt.partialize(spec)(size=SIZE, rank=2)
    assert len(composed) == 2 and composed.factor == [(0,), (1,)] and isinstance(composed[1], ftt.MultiplicativeUpdate)
    with pytest.raises(ValueError, match="Cannot parse solver element"):
        ftt.parse_solver(["hals", 3])
    specs = [
        (["hals-0", "mu-1"], ["hals-0", "mu-1"]),
        (["nncd", (ftx.MultiplicativeUpdate, {"factor": 1})], ["nncd", (ftt.MultiplicativeUpdate, {"factor": 1})]),
    ]
    with jax.enable_x64(True):
        for spec_j, spec_t in specs:
            m_j, variables, m_t = _pair(solver=spec_j, solver_t=spec_t)
            x = _x(np.float64)
            y_j = np.asarray(m_j.apply(variables, jnp.asarray(x)))
            y_t = m_t(torch.from_numpy(x)).detach().numpy()
            np.testing.assert_allclose(y_t, y_j, rtol=1e-10, atol=1e-12)


def test_weighted_mu_takes_w_through_decompose():
    """``decompose(x, w=w)`` passes the weight to WMU; factors and ``loss(x, u, v, w)`` against JAX, float64 to 1e-10."""
    with jax.enable_x64(True):
        m_j, variables, m_t = _pair(solver="wmu")
        x, w = _x(np.float64), _x(np.float64, seed=1)
        u_j, v_j = m_j.apply(variables, jnp.asarray(x), w=jnp.asarray(w), method=m_j.decompose)
        loss_j = m_j.apply(variables, jnp.asarray(x), u_j, v_j, jnp.asarray(w), method=m_j.loss)
        u_t, v_t = m_t.decompose(torch.from_numpy(x), w=torch.from_numpy(w))
        loss_t = m_t.loss(torch.from_numpy(x), u_t, v_t, torch.from_numpy(w))
        unweighted = m_t.decompose(torch.from_numpy(x))[0]
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-10)
    assert not torch.allclose(unweighted, u_t)  # the weight changes the solve


def test_projection_as_function_or_factory():
    """``project`` takes an elementwise function or a factory (a class, ``(class, kwargs)``): ``cd`` with relu given
    either way equals ``hals``; against JAX's ``cd`` with ``project=jax.nn.relu``, float64 to 1e-10."""
    assert _resolve_project(None)(torch.tensor(-1.0)) == -1.0
    assert _resolve_project(torch.nn.ReLU)(torch.tensor(-1.0)) == 0.0
    assert _resolve_project((torch.nn.LeakyReLU, {"negative_slope": 0.5}))(torch.tensor(-1.0)) == -0.5
    with jax.enable_x64(True):
        m_j = ftx.MatrixFactorization(size=SIZE, rank=2, init_method="uniform", solver="cd", project=jax.nn.relu)
        variables = _tables(m_j)
        x = _x(np.float64)
        y_j = np.asarray(m_j.apply(variables, jnp.asarray(x)))
        for project in (torch.relu, torch.nn.ReLU):
            m_t = ftt.MatrixFactorization(SIZE, rank=2, init_method="uniform", solver="cd", project=project)
            tables = variables["buffers"]["initializer"]
            m_t.init.u0.copy_(torch.tensor(np.asarray(tables["u0"])))
            m_t.init.v0.copy_(torch.tensor(np.asarray(tables["v0"])))
            np.testing.assert_allclose(m_t(torch.from_numpy(x)).numpy(), y_j, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pinv_cut_off_is_jax_s(dtype):
    """``LeastSquares``'s pseudo-inverse drops singular values up to ``10 max(M, N) eps`` of the largest, as
    ``jnp.linalg.pinv`` does by default (torch's own default keeps those above a tenth of that)."""
    eps = np.finfo(dtype).eps
    u, _ = np.linalg.qr(np.random.default_rng(2).standard_normal((8, 2)))
    vt, _ = np.linalg.qr(np.random.default_rng(3).standard_normal((2, 2)))
    a = (u * np.array([1.0, 30 * eps])) @ vt  # the second value between torch's cut-off (8 eps) and JAX's (80 eps)
    a = a.astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jnp.linalg.pinv(jnp.asarray(a)))
    got = _pinv(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert np.abs(torch.linalg.pinv(torch.from_numpy(a)).numpy()).max() > 1e3 * np.abs(want).max()


@pytest.mark.parametrize("solver", ["nnls", "smu", ("hals-0", "mu-1")])
@pytest.mark.parametrize("num_grad_steps", [None, 2, 0])
def test_gradient_truncation_matches_jax(solver, num_grad_steps):
    """``num_grad_steps``: the leading iterations see a detached x, as JAX's ``stop_gradient``; the gradient of
    ``sum(y^2)`` with respect to x in float64 to 1e-9 (0 steps: no gradient, JAX's is zero)."""
    solver = list(solver) if isinstance(solver, tuple) else solver
    with jax.enable_x64(True):
        m_j, variables, m_t = _pair(solver=solver, num_iters=4, num_grad_steps=num_grad_steps)
        x = _x(np.float64)
        g_j = np.asarray(jax.grad(lambda x: (m_j.apply(variables, x) ** 2).sum())(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        y = m_t(xt)
        if y.requires_grad:
            (y**2).sum().backward()
            g_t = xt.grad.numpy()
        else:
            g_t = np.zeros_like(x)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-9, atol=1e-9 * np.abs(g_j).max() + 1e-14)
