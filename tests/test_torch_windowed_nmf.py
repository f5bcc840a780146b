"""Port parity: K1's plain version, forward and gradient, against the JAX windowed-NMF kernel and SWMatricize -> NMF.

``windowed_nmf_multi`` runs its Pallas kernels (forward and backward) in
interpret mode on the CPU, as ``tests/test_pallas.py`` runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu.ops.pallas.windowed_nmf_kernel import windowed_nmf_multi

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.ops.kernels import (
    windowed_nmf,
    windowed_nmf_backward,
    windowed_nmf_backward_plain,
    windowed_nmf_factors,
    windowed_nmf_plain,
    windowed_nmf_reconstruct,
)

torch.set_num_threads(1)

SHIFTS = {"four": (None, 2, 4, 6), "zero": ((0, 0, 0),)}


def _inputs(shape=(2, 16, 16, 16, 16), d=8, p=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    u0 = rng.random((d, 1)).astype(np.float32)
    v0 = rng.random((p**3, 1)).astype(np.float32)
    return x, u0, v0


@pytest.mark.parametrize("solver", ["hals", "mu"])
@pytest.mark.parametrize("shifts", list(SHIFTS))
def test_plain_matches_jax_kernel(solver, shifts):
    """f32 against the interpret-mode Pallas kernel: rtol 1e-4, atol 2e-5 (summation order)."""
    x, u0, v0 = _inputs()
    sh = SHIFTS[shifts]
    y_j = np.asarray(windowed_nmf_multi(jnp.asarray(x), jnp.asarray(u0), jnp.asarray(v0), 8, 8, sh, solver, 5))
    y_t = windowed_nmf_plain(torch.from_numpy(x), torch.from_numpy(u0), torch.from_numpy(v0), 8, 8, sh, solver, 5)
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("solver", ["hals", "mu"])
@pytest.mark.parametrize("shifts", list(SHIFTS))
def test_plain_matches_swmatricize_nmf(solver, shifts):
    """The kernel's math equals the module chain SWMatricize -> NMF -> inverse, in the port and in JAX."""
    shape = (1, 16, 8, 24, 8)  # non-cubic volume, two heads of 4
    x, u0, v0 = _inputs(shape, d=4, p=4, seed=1)
    sh = SHIFTS[shifts]
    kw = dict(head_dim=4, patch_size=4, shifts=list(sh))
    sw_t, sw_j = ftt.SWMatricize(shape, **kw), ftx.SWMatricize(shape, data_format="channels_last", **kw)
    nmf = ftt.NMF(sw_t.output_size[2:], rank=1, num_iters=3, solver=solver)
    nmf.init.u0.copy_(torch.from_numpy(u0))
    nmf.init.v0.copy_(torch.from_numpy(v0))
    xt = torch.from_numpy(x)
    y_chain = sw_t.inverse_forward(nmf(sw_t(xt))).detach().numpy()
    y_t = windowed_nmf_plain(xt, torch.from_numpy(u0), torch.from_numpy(v0), 4, 4, sh, solver, 3).numpy()
    np.testing.assert_allclose(y_t, y_chain, rtol=1e-5, atol=1e-6)

    nmf_j = ftx.NMF(size=sw_j.output_size[2:], rank=1, num_iters=3, init_method="uniform", solver=solver)
    variables = {"buffers": {"initializer": {"u0": jnp.asarray(u0), "v0": jnp.asarray(v0)}}}
    y_jchain = np.asarray(sw_j.inverse_forward(nmf_j.apply(variables, sw_j(jnp.asarray(x)))))
    np.testing.assert_allclose(y_t, y_jchain, rtol=1e-4, atol=2e-5)


def test_plain_bf16_matches_jax_kernel():
    """bf16 in, bf16 out, f32 solve: within bf16 rounding of the JAX kernel (which also sums shifts in bf16)."""
    x, u0, v0 = _inputs(seed=2)
    sh = SHIFTS["four"]
    y_j = windowed_nmf_multi(jnp.asarray(x, jnp.bfloat16), jnp.asarray(u0), jnp.asarray(v0), 8, 8, sh, "hals", 5)
    y_t = windowed_nmf_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(u0), torch.from_numpy(v0), 8, 8, sh)
    assert y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(y_t.float().numpy(), np.asarray(y_j.astype(jnp.float32)), rtol=2e-2, atol=2e-2)


def test_wrapper_on_cpu_is_plain():
    """A CPU tensor goes to the plain version: bit-identical results, no launch counted."""
    x, u0, v0 = _inputs(seed=3)
    args = (torch.from_numpy(x), torch.from_numpy(u0), torch.from_numpy(v0), 8, 8, SHIFTS["four"], "hals", 5)
    before = windowed_nmf_factors.launches, windowed_nmf_reconstruct.launches
    np.testing.assert_array_equal(windowed_nmf(*args).numpy(), windowed_nmf_plain(*args).numpy())
    assert (windowed_nmf_factors.launches, windowed_nmf_reconstruct.launches) == before


GRAD_SHAPE = (1, 16, 16, 16, 8)  # 8 windows of one head


def _grad_inputs(seed, zero_windows=False):
    x, u0, v0 = _inputs(GRAD_SHAPE, seed=seed)
    if zero_windows:  # whole windows of zeros, as the ReLU leaves BraTS background
        x[:, :8, :, :8] = 0.0
    g = np.random.default_rng(seed + 100).standard_normal(GRAD_SHAPE).astype(np.float32)
    return x, u0, v0, g


def _jax_dx(x, u0, v0, g, sh, solver, num_grad_steps):
    fn = lambda t: windowed_nmf_multi(t, jnp.asarray(u0), jnp.asarray(v0), 8, 8, sh, solver, 5, num_grad_steps=num_grad_steps)
    return np.asarray(jax.vjp(fn, jnp.asarray(x))[1](jnp.asarray(g))[0])


@pytest.mark.parametrize("num_grad_steps", [None, 2, 0])
@pytest.mark.parametrize("solver", ["hals", "mu"])
@pytest.mark.parametrize("shifts", list(SHIFTS))
def test_plain_gradient_matches_jax_kernel(shifts, solver, num_grad_steps):
    """dx for a random cotangent against the interpret-mode Pallas backward: f32 rtol 1e-4, atol 2e-5.

    ``num_grad_steps=0`` differentiates no iteration and gives exactly zero.
    """
    x, u0, v0, g = _grad_inputs(seed=4)
    sh = SHIFTS[shifts]
    dx_j = _jax_dx(x, u0, v0, g, sh, solver, num_grad_steps)
    args = (torch.from_numpy(u0), torch.from_numpy(v0), 8, 8, sh, solver, 5, 1e-16, num_grad_steps)
    dx_t = windowed_nmf_backward_plain(torch.from_numpy(x), torch.from_numpy(g), *args)
    np.testing.assert_allclose(dx_t.numpy(), dx_j, rtol=1e-4, atol=2e-5)
    if num_grad_steps == 0:
        assert not dx_t.any() and not dx_j.any()


@pytest.mark.parametrize("num_grad_steps", [None, 2])
def test_plain_gradient_with_zero_windows_matches_jax_kernel(num_grad_steps):
    """All-zero windows drive u.u below eps = 1e-16, so 1/(b + eps) ~ 1e16 multiplies the cotangents.

    The gradient stays finite and equals JAX's: f32 rtol 1e-4, atol 2e-5.
    """
    x, u0, v0, g = _grad_inputs(seed=5, zero_windows=True)
    sh = SHIFTS["four"]
    dx_j = _jax_dx(x, u0, v0, g, sh, "hals", num_grad_steps)
    dx_t = windowed_nmf_backward_plain(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(u0), torch.from_numpy(v0), 8, 8, sh, "hals", 5,
        1e-16, num_grad_steps,
    )
    assert np.isfinite(dx_j).all() and torch.isfinite(dx_t).all()
    assert dx_t[:, :8, :, :8].abs().max() > 0  # the zero windows do receive a gradient
    np.testing.assert_allclose(dx_t.numpy(), dx_j, rtol=1e-4, atol=2e-5)


def test_plain_gradient_f64_matches_jax_module_chain():
    """f64, four shifts, against jax.vjp of SWMatricize -> NMF -> inverse under x64: 1e-9.

    (``xla_windowed_nmf_reconstruct`` solves in f32 whatever it is given, so the
    module chain is the f64 oracle.)
    """
    x, u0, v0, g = (a.astype(np.float64) for a in _grad_inputs(seed=6))
    sh = SHIFTS["four"]
    with jax.enable_x64(True):
        sw = ftx.SWMatricize(GRAD_SHAPE, data_format="channels_last", head_dim=8, patch_size=8, shifts=list(sh))
        nmf = ftx.NMF(size=sw.output_size[2:], rank=1, num_iters=5, init_method="uniform", solver="hals")
        variables = {"buffers": {"initializer": {"u0": jnp.asarray(u0), "v0": jnp.asarray(v0)}}}
        fn = lambda t: sw.inverse_forward(nmf.apply(variables, sw(t)))
        dx_j = np.asarray(jax.vjp(fn, jnp.asarray(x))[1](jnp.asarray(g))[0])
    assert dx_j.dtype == np.float64
    dx_t = windowed_nmf_backward_plain(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(u0), torch.from_numpy(v0), 8, 8, sh, "hals", 5
    )
    assert dx_t.dtype == torch.float64
    np.testing.assert_allclose(dx_t.numpy(), dx_j, rtol=1e-9, atol=1e-12)


def test_wrapper_gradient_on_cpu_is_plain_and_skips_the_tables():
    """Autograd through the wrapper on the CPU equals windowed_nmf_backward; u0 and v0 receive no gradient."""
    x, u0, v0, g = _grad_inputs(seed=7)
    xt = torch.from_numpy(x).requires_grad_(True)
    u0t, v0t = torch.from_numpy(u0), torch.from_numpy(v0)
    before = windowed_nmf_backward.launches
    y = windowed_nmf(xt, u0t, v0t, 8, 8, SHIFTS["four"], "hals", 5)
    y.backward(torch.from_numpy(g))
    dx = windowed_nmf_backward(torch.from_numpy(x), torch.from_numpy(g), u0t, v0t, 8, 8, SHIFTS["four"], "hals", 5)
    np.testing.assert_array_equal(xt.grad.numpy(), dx.numpy())
    assert u0t.grad is None and v0t.grad is None
    assert windowed_nmf_backward.launches == before
