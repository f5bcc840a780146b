"""Port parity: K4's plain version, forward and gradient, against the JAX flat-NMF kernel.

``nmf_reconstruct`` of the JAX package runs its Pallas kernel in interpret
mode on the CPU, as ``tests/test_pallas.py`` runs it; its backward recomputes
the solve in XLA.  The port's wrapper takes the plain version for CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu.ops.pallas.nmf_kernel import nmf_reconstruct as jax_nmf_reconstruct

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.ops.kernels import (
    nmf_reconstruct,
    nmf_reconstruct_backward,
    nmf_reconstruct_backward_plain,
    nmf_reconstruct_plain,
)
from factorizer_tpu_torch.ops.kernels import nmf as kernel_module
from factorizer_tpu_torch.ops.kernels.nmf import supports, supports_backward

torch.set_num_threads(1)

# Largest |difference| allowed, as a share of the output's largest entry.  Rank 1 repeats five closed-form
# updates whose sums run in another order: 2e-5.  Rank > 1 HALS subtracts sums of nearly equal size
# (a[:, r] - sum_j u[:, j] b[j, r]) before the division, so the order of summation moves the f32 result
# more: 2e-4.
BAND = {1: 2e-5, 2: 2e-4, 3: 2e-4, 4: 2e-4}


def _inputs(shape=(6, 8, 64), rank=1, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(dtype)
    u0 = rng.random((shape[-2], rank)).astype(dtype)
    v0 = rng.random((shape[-1], rank)).astype(dtype)
    return x, u0, v0


def _within(out, ref, band):
    assert np.abs(out - ref).max() <= band * np.abs(ref).max(), (np.abs(out - ref).max(), np.abs(ref).max())


@pytest.mark.parametrize("rank", [1, 2, 4])
@pytest.mark.parametrize("solver", ["hals", "mu"])
def test_plain_matches_jax_kernel(solver, rank):
    """f32 against the interpret-mode Pallas kernel at (6, 8, 64): within BAND of the largest entry."""
    x, u0, v0 = _inputs(rank=rank, seed=rank)
    y_j = np.asarray(jax_nmf_reconstruct(jnp.asarray(x), jnp.asarray(u0), jnp.asarray(v0), solver, 5))
    y_t = nmf_reconstruct_plain(torch.from_numpy(x), torch.from_numpy(u0), torch.from_numpy(v0), solver, 5)
    assert y_t.shape == x.shape and y_t.dtype == torch.float32
    _within(y_t.numpy(), y_j, BAND[rank])


def test_plain_matches_jax_kernel_at_an_odd_size():
    """(5, 5, 37) at rank 3, with two leading batch axes on the port's side: no size is a multiple of anything."""
    x, u0, v0 = _inputs((5, 5, 37), rank=3, seed=7)
    y_j = np.asarray(jax_nmf_reconstruct(jnp.asarray(x), jnp.asarray(u0), jnp.asarray(v0), "hals", 5))
    y_t = nmf_reconstruct_plain(torch.from_numpy(x), torch.from_numpy(u0), torch.from_numpy(v0), "hals", 5)
    _within(y_t.numpy(), y_j, BAND[3])
    x4 = torch.from_numpy(x).reshape(5, 1, 5, 37)
    y4 = nmf_reconstruct_plain(x4, torch.from_numpy(u0), torch.from_numpy(v0), "hals", 5)
    np.testing.assert_array_equal(y4.reshape(5, 5, 37).numpy(), y_t.numpy())


def test_plain_bf16_matches_jax_kernel():
    """bf16 in, bf16 out, f32 solve on both sides: within one bf16 rounding (2^-8 of the largest entry)."""
    x, u0, v0 = _inputs(seed=11)
    y_j = jax_nmf_reconstruct(jnp.asarray(x, jnp.bfloat16), jnp.asarray(u0), jnp.asarray(v0), "hals", 5)
    y_t = nmf_reconstruct_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(u0), torch.from_numpy(v0))
    assert y_t.dtype == torch.bfloat16 and y_j.dtype == jnp.bfloat16
    _within(y_t.float().numpy(), np.asarray(y_j.astype(jnp.float32)), 2.0**-8)


@pytest.mark.parametrize("shape,rank,dtype", [((4, 8, 512), 1, np.float32), ((4, 8, 512), 3, np.float32),
                                               ((4, 8, 64), 1, "bfloat16")])
def test_plain_matches_jax_kernel_at_the_register_sizes(shape, rank, dtype):
    """The sizes the card's register kernels take, (8, 512) and (8, 64): f32 within BAND, bf16 within one bf16
    rounding (2^-8 of the largest entry), against the interpret-mode Pallas kernel."""
    x, u0, v0 = _inputs(shape, rank=rank, seed=50 + rank)
    if dtype == "bfloat16":
        y_j = jax_nmf_reconstruct(jnp.asarray(x, jnp.bfloat16), jnp.asarray(u0), jnp.asarray(v0), "hals", 5)
        y_t = nmf_reconstruct_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(u0), torch.from_numpy(v0), "hals", 5)
        assert y_t.dtype == torch.bfloat16
        _within(y_t.float().numpy(), np.asarray(y_j.astype(jnp.float32)), 2.0**-8)
    else:
        y_j = np.asarray(jax_nmf_reconstruct(jnp.asarray(x), jnp.asarray(u0), jnp.asarray(v0), "hals", 5))
        y_t = nmf_reconstruct_plain(torch.from_numpy(x), torch.from_numpy(u0), torch.from_numpy(v0), "hals", 5)
        _within(y_t.numpy(), y_j, BAND[rank])


def _jax_module(x, u0, v0, solver, num_grad_steps=None):
    """The JAX ``NMF`` module on its CPU route, the ``decompose`` chain, and its variables: the f64 oracle.
    (``xla_nmf_reconstruct`` and the kernel's backward recompute accumulate their products in f32 whatever
    they are given.)"""
    nmf = ftx.NMF(size=x.shape[-2:], rank=u0.shape[1], num_iters=5, init_method="uniform", solver=solver,
                  num_grad_steps=num_grad_steps)
    return nmf, {"buffers": {"initializer": {"u0": jnp.asarray(u0), "v0": jnp.asarray(v0)}}}


@pytest.mark.parametrize("rank", [1, 2])
def test_plain_f64_matches_xla_reference(rank):
    """f64 against the JAX module's XLA chain under x64: 1e-10 (the semantic check)."""
    x, u0, v0 = _inputs(rank=rank, seed=13, dtype=np.float64)
    with jax.enable_x64(True):
        nmf, variables = _jax_module(x, u0, v0, "hals")
        y_j = np.asarray(nmf.apply(variables, jnp.asarray(x)))
    assert y_j.dtype == np.float64
    y_t = nmf_reconstruct_plain(torch.from_numpy(x), torch.from_numpy(u0), torch.from_numpy(v0), "hals", 5)
    assert y_t.dtype == torch.float64
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("solver", ["hals", "mu"])
def test_all_zero_matrices(solver):
    """An all-zero matrix: under HALS u falls to ~eps, u.u far below eps, so v = eps / eps = 1 and the matrix
    reconstructs to eps / N, a denormal-free 1.5625e-18 that flush-to-zero or an approximate division would
    lose.  The port equals the JAX kernel there to 1e-5 of that value, and elsewhere within the band."""
    x, u0, v0 = _inputs(seed=17)
    x[::2] = 0.0
    y_j = np.asarray(jax_nmf_reconstruct(jnp.asarray(x), jnp.asarray(u0), jnp.asarray(v0), solver, 5))
    y_t = nmf_reconstruct_plain(torch.from_numpy(x), torch.from_numpy(u0), torch.from_numpy(v0), solver, 5).numpy()
    assert np.isfinite(y_t).all()
    _within(y_t, y_j, BAND[1])
    if solver == "hals":
        np.testing.assert_allclose(y_t[::2], 1e-16 / 64, rtol=1e-5)
        np.testing.assert_allclose(y_t[::2], y_j[::2], rtol=1e-5)


def _jax_dx(x, u0, v0, g, solver, num_grad_steps):
    fn = lambda t: jax_nmf_reconstruct(t, jnp.asarray(u0), jnp.asarray(v0), solver, 5, 1e-16, num_grad_steps)
    return np.asarray(jax.vjp(fn, jnp.asarray(x))[1](jnp.asarray(g))[0])


@pytest.mark.parametrize("num_grad_steps", [None, 2, 0])
@pytest.mark.parametrize("rank", [1, 2])
def test_plain_gradient_matches_jax(rank, num_grad_steps):
    """dx for a random cotangent against ``jax.vjp`` of ``nmf_reconstruct``, f32: ten times the forward's band
    (the reverse sweep repeats the forward's sums and divides by the same small denominators).
    ``num_grad_steps=0`` differentiates no iteration and gives exactly zero."""
    x, u0, v0 = _inputs(rank=rank, seed=20 + rank)
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    dx_j = _jax_dx(x, u0, v0, g, "hals", num_grad_steps)
    dx_t = nmf_reconstruct_backward_plain(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(u0), torch.from_numpy(v0), "hals", 5, 1e-16, num_grad_steps
    ).numpy()
    if num_grad_steps == 0:
        assert not dx_t.any() and not dx_j.any()
    else:
        _within(dx_t, dx_j, 10 * BAND[rank])


def test_plain_mu_gradient_at_the_register_size():
    """MU's dx at (4, 8, 512), the register backward's size, against ``jax.vjp`` of ``nmf_reconstruct``, f32, on a
    strictly positive input (as the card's checks take MU): ten times the forward's band."""
    x, u0, v0 = _inputs((4, 8, 512), seed=60)
    x += 0.05
    g = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    dx_j = _jax_dx(x, u0, v0, g, "mu", None)
    dx_t = nmf_reconstruct_backward_plain(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(u0), torch.from_numpy(v0), "mu", 5, 1e-16, None
    ).numpy()
    _within(dx_t, dx_j, 10 * BAND[1])


@pytest.mark.parametrize("rank,solver,num_grad_steps", [(1, "hals", None), (2, "hals", 2), (2, "mu", None)])
def test_plain_gradient_f64_matches_jax(rank, solver, num_grad_steps):
    """f64 gradient against ``jax.vjp`` of the JAX module's XLA chain under x64, with its ``stop_gradient`` cut: 1e-10."""
    x, u0, v0 = _inputs(rank=rank, seed=30 + rank, dtype=np.float64)
    g = np.random.default_rng(6).standard_normal(x.shape)
    with jax.enable_x64(True):
        nmf, variables = _jax_module(x, u0, v0, solver, num_grad_steps)
        dx_j = np.asarray(jax.vjp(lambda t: nmf.apply(variables, t), jnp.asarray(x))[1](jnp.asarray(g))[0])
    assert dx_j.dtype == np.float64
    dx_t = nmf_reconstruct_backward_plain(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(u0), torch.from_numpy(v0), solver, 5, 1e-16, num_grad_steps
    )
    assert dx_t.dtype == torch.float64
    np.testing.assert_allclose(dx_t.numpy(), dx_j, rtol=1e-10, atol=1e-12)


def test_wrapper_on_cpu_is_plain():
    """A CPU tensor goes to the plain versions, forward and backward: bit-identical, nothing launched or counted;
    u0 and v0 receive no gradient; an empty batch comes back empty."""
    x, u0, v0 = _inputs(rank=2, seed=40)
    g = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    u0t, v0t = torch.from_numpy(u0), torch.from_numpy(v0)
    before = (nmf_reconstruct.launches, nmf_reconstruct_backward.launches, nmf_reconstruct_backward.recomputes)
    y = nmf_reconstruct(xt, u0t, v0t, "hals", 5)
    np.testing.assert_array_equal(y.detach().numpy(), nmf_reconstruct_plain(torch.from_numpy(x), u0t, v0t, "hals", 5).numpy())
    y.backward(torch.from_numpy(g))
    dx = nmf_reconstruct_backward(torch.from_numpy(x), torch.from_numpy(g), u0t, v0t, "hals", 5)
    np.testing.assert_array_equal(xt.grad.numpy(), dx.numpy())
    assert u0t.grad is None and v0t.grad is None
    assert (nmf_reconstruct.launches, nmf_reconstruct_backward.launches, nmf_reconstruct_backward.recomputes) == before
    assert nmf_reconstruct(torch.empty(0, 8, 64), u0t, v0t).shape == (0, 8, 64)
    with pytest.raises(ValueError, match="solver"):
        nmf_reconstruct(torch.from_numpy(x), u0t, v0t, "cd")


def test_supports_is_the_cards_size_rule():
    """What the kernels take: hals / mu, rank 1 to 4, and a matrix that fits a block's shared memory together with
    its factors.  The rank-1 backward kernel keeps x, g and every iterate, so it takes fewer sizes than the forward;
    at rank above 1 the backward is a recompute in torch operations and takes what the forward takes."""
    assert supports("hals", 1, (8, 512)) and supports("mu", 4, (8, 512)) and supports("hals", 3, (5, 37))
    assert supports("hals", 1, (8, 64)) and supports("hals", 1, (256, 27))
    assert not supports("cd", 1, (8, 512)) and not supports("hals", 5, (8, 512)) and not supports("hals", 0, (8, 512))
    assert not supports("hals", 1, (32, 128**3))      # the default global Matricize at stage 0
    assert not supports("hals", 2, (64, 1024))        # 64 K floats and factors: above 227 KB
    for size in [(8, 512), (8, 64), (256, 27), (5, 37)]:
        assert supports_backward("hals", 1, size) and supports_backward("mu", 1, size)
    assert supports("hals", 1, (8, 4096)) and not supports_backward("hals", 1, (8, 4096))  # the forward alone fits
    assert supports("hals", 2, (8, 4096)) and supports_backward("hals", 2, (8, 4096))      # no backward kernel to fit
    assert supports("hals", 1, (512, 64)) and not supports_backward("hals", 1, (512, 64))  # more rows than a block has threads
    assert not supports_backward("hals", 1, (32, 128**3)) and not supports_backward("cd", 1, (8, 512))


def test_matrix_factorization_routes_by_shape():
    """``MatrixFactorization.forward`` sends supported batches through ``nmf_reconstruct`` and the rest (a single
    matrix, an unsupported size) through the ``decompose`` chain; on the CPU the two agree bit for bit.  A size
    that only the forward kernel fits goes to the wrapper unless a gradient with respect to the input is recorded.
    The dtype never decides the route: bf16, f16 and f64 reach the wrapper like f32."""
    calls = []
    wrapper = kernel_module.nmf_reconstruct

    def spy(x, *args):
        calls.append(tuple(x.shape))
        return wrapper(x, *args)

    cases = [((8, 64), 2, (3, 5), False, True), ((8, 64), 1, (), False, False), ((64, 1024), 2, (2,), False, False),
             ((8, 4096), 1, (2,), False, True), ((8, 4096), 1, (2,), True, False), ((8, 4096), 2, (2,), True, True),
             ((8, 64), 1, (4,), True, True)]
    kernel_module.nmf_reconstruct = spy
    try:
        for size, rank, batch, with_grad, routed in cases:
            nmf = ftt.NMF(size, rank=rank, generator=torch.Generator().manual_seed(1))
            x = torch.rand(*batch, *size, generator=torch.Generator().manual_seed(2)).requires_grad_(with_grad)
            chain = nmf.reconstruct(*nmf.decompose(x))
            del calls[:]
            y = nmf(x)
            assert bool(calls) == routed, (size, rank, with_grad)
            assert torch.equal(y, chain), (size, rank, with_grad)
            if with_grad:
                g = torch.rand(y.shape, generator=torch.Generator().manual_seed(3))
                assert torch.equal(*(torch.autograd.grad(t, x, g)[0] for t in (y, chain))), (size, rank)
            with torch.no_grad():  # serving: the forward's fit alone decides
                del calls[:]
                nmf(x)
                assert bool(calls) == (nmf.supports() and x.ndim >= 3), (size, rank)
        nmf = ftt.NMF((8, 64), rank=1, num_grad_steps=2)
        for dtype in (torch.bfloat16, torch.float16, torch.float64):
            x = torch.rand(4, 8, 64).to(dtype)
            del calls[:]
            y = nmf(x)
            assert calls == [(4, 8, 64)] and y.dtype == dtype
            solved_in = torch.float64 if dtype == torch.float64 else torch.float32
            assert torch.equal(y, nmf.reconstruct(*nmf.decompose(x.to(solved_in))).to(dtype))
    finally:
        kernel_module.nmf_reconstruct = wrapper


def test_wrapper_raises_rather_than_giving_way():
    """What the wrappers refuse, they refuse before anything is built or launched, so the checks run without a
    card: a dtype the kernels do not read (float64, named in the error; float16 is read), and a rank-1 size that
    the backward kernel cannot hold."""
    from factorizer_tpu_torch.ops.kernels import build
    from factorizer_tpu_torch.ops.kernels.nmf import _check

    assert build.dtype_code(torch.float16) == 2
    for dtype in (torch.float64, torch.int32):
        with pytest.raises(TypeError, match=f"float32, bfloat16 or float16 activations, got {dtype}"):
            build.dtype_code(dtype)
    x, u0, v0 = torch.rand(2, 64, 1024), torch.rand(64, 2), torch.rand(1024, 2)
    with pytest.raises(ValueError, match="do not cover"):
        _check(x, u0, v0, "hals", 5)
    assert _check(torch.rand(2, 8, 4096), torch.rand(8, 1), torch.rand(4096, 1), "hals", 5) == (2, 8, 4096, 1)
