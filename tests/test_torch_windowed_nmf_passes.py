"""K1's forward as two passes: the factors pass and the reconstruct pass, plain, composed and held against the
one-pass plain version and the JAX windowed-NMF kernel (interpret-mode Pallas on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorizer_tpu.ops.pallas.windowed_nmf_kernel import windowed_nmf_multi

from factorizer_tpu_torch.ops.kernels import (
    windowed_nmf,
    windowed_nmf_factors,
    windowed_nmf_factors_plain,
    windowed_nmf_plain,
    windowed_nmf_reconstruct,
    windowed_nmf_reconstruct_plain,
)
from factorizer_tpu_torch.ops.kernels.windowed_nmf import MAX_SHIFTS, _shift_table, factor_shapes

torch.set_num_threads(1)

SHIFTS = {"one": (None,), "four": (None, 2, 4, 6)}
# More shifts than one forward launch takes (MAX_SHIFTS): the kernels run them in groups.
TEN = (None, 1, 2, 3, 4, 5, 6, 7, (1, 2, 3), (3, 2, 1))
SHAPES = {8: (2, 16, 16, 16, 16), 4: (2, 8, 8, 12, 16)}  # patch -> a volume of two heads of 8


def _inputs(p, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(SHAPES[p]).astype(dtype), rng.random((8, 1)).astype(dtype), rng.random((p**3, 1)).astype(dtype))


def _two_passes(x, u0, v0, p, shifts, solver):
    U, V = windowed_nmf_factors_plain(x, u0, v0, 8, p, shifts, solver, 5)
    return windowed_nmf_reconstruct_plain(U, V, x.shape, x.dtype, 8, p, shifts)


@pytest.mark.parametrize("p", [8, 4])
@pytest.mark.parametrize("solver", ["hals", "mu"])
@pytest.mark.parametrize("shifts", [*SHIFTS, "ten"])
def test_passes_compose_to_plain_f64(p, solver, shifts):
    """float64: the composition is the one-pass plain version's arithmetic, to 1e-12."""
    x, u0, v0 = (torch.from_numpy(a) for a in _inputs(p, np.float64, seed=1))
    sh = TEN if shifts == "ten" else SHIFTS[shifts]
    y = _two_passes(x, u0, v0, p, sh, solver)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), windowed_nmf_plain(x, u0, v0, 8, p, sh, solver, 5).numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("p", [8, 4])
@pytest.mark.parametrize("solver", ["hals", "mu"])
@pytest.mark.parametrize("shifts", list(SHIFTS))
def test_passes_match_jax_kernel(p, solver, shifts):
    """f32 against the interpret-mode Pallas kernel: rtol 1e-4, atol 2e-5 (summation order)."""
    x, u0, v0 = _inputs(p, seed=2)
    sh = SHIFTS[shifts]
    y_j = np.asarray(windowed_nmf_multi(jnp.asarray(x), jnp.asarray(u0), jnp.asarray(v0), 8, p, sh, solver, 5))
    y_t = _two_passes(torch.from_numpy(x), torch.from_numpy(u0), torch.from_numpy(v0), p, sh, solver)
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-4, atol=2e-5)


def test_factor_shapes():
    """(n, B, G, heads, d) and (n, B, G, heads, p^3): the buffer is (d + p^3) / (d p^3) of the volume per shift."""
    shape = (2, 128, 128, 128, 32)
    u, v = factor_shapes(shape, 8, 8, 4)
    assert u == (4, 2, 4096, 4, 8) and v == (4, 2, 4096, 4, 512)
    per_shift = (np.prod(u) + np.prod(v)) / 4 / np.prod(shape)
    assert per_shift == pytest.approx((8 + 512) / (8 * 512))
    assert factor_shapes((8, 64, 64, 64, 32), 8, 4, 4) == ((4, 8, 4096, 4, 8), (4, 8, 4096, 4, 64))
    x, u0, v0 = (torch.from_numpy(a) for a in _inputs(4))
    U, V = windowed_nmf_factors_plain(x, u0, v0, 8, 4, SHIFTS["four"])
    assert (tuple(U.shape), tuple(V.shape)) == factor_shapes(x.shape, 8, 4, 4)


def test_shift_table():
    """Shifts go to the kernel as n x 3 ints modulo the patch, any number of them (the kernels take MAX_SHIFTS a
    launch and group the rest); none raises."""
    assert list(_shift_table((None, 2, (1, 9, 3)), 8)) == [0, 0, 0, 2, 2, 2, 1, 1, 3]
    assert len(TEN) > MAX_SHIFTS and list(_shift_table(TEN, 8))[-6:] == [1, 2, 3, 3, 2, 1]
    with pytest.raises(ValueError, match="shift"):
        _shift_table((), 8)


def test_pass_wrappers_on_cpu_are_plain():
    """CPU tensors take the plain passes, bit for bit, and count no launch; the composed wrapper too."""
    x, u0, v0 = (torch.from_numpy(a) for a in _inputs(8, seed=3))
    before = windowed_nmf_factors.launches, windowed_nmf_reconstruct.launches
    U, V = windowed_nmf_factors(x, u0, v0, 8, 8, SHIFTS["four"])
    U_p, V_p = windowed_nmf_factors_plain(x, u0, v0, 8, 8, SHIFTS["four"])
    assert torch.equal(U, U_p) and torch.equal(V, V_p)
    y = windowed_nmf_reconstruct(U, V, x.shape, x.dtype, 8, 8, SHIFTS["four"])
    assert torch.equal(y, windowed_nmf_reconstruct_plain(U, V, x.shape, x.dtype, 8, 8, SHIFTS["four"]))
    assert torch.equal(windowed_nmf(x, u0, v0, 8, 8, SHIFTS["four"]), windowed_nmf_plain(x, u0, v0, 8, 8, SHIFTS["four"]))
    assert (windowed_nmf_factors.launches, windowed_nmf_reconstruct.launches) == before
