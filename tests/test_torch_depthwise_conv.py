"""Port parity for K3: the depthwise convolution, its input gradient and its weight gradient.

On the CPU the port's wrappers take the plain version (a grouped
``F.conv{2,3}d``); the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_depthwise_conv.py`` does: the lane-packed kernels through
``_fwd_impl`` / ``_dw_impl`` and the ``custom_vjp`` entry points, the unpacked
v1 stencil likewise.  Inputs come from a numpy seed and go through both sides.
Random taps and non-cubic kernel sizes: a symmetric filter would hide a wrong
orientation or tap order.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorizer_tpu.ops.pallas import depthwise_conv as v1
from factorizer_tpu.ops.pallas import depthwise_packed as dpk

from factorizer_tpu_torch.ops.kernels import (
    depthwise_conv,
    depthwise_conv_dw,
    depthwise_conv_dw_plain,
    depthwise_conv_plain,
)
from factorizer_tpu_torch.ops.kernels.depthwise_conv import flip_taps

torch.set_num_threads(1)

# f32 on both sides, sums of at most 49 products in another order: 1e-5 of the largest entry.
RTOL = 1e-5

PACKED_3D = [
    ((1, 8, 8, 8, 16), (3, 3, 3)),
    ((2, 8, 8, 16, 32), (3, 3, 3)),
    ((1, 4, 8, 16, 32), (1, 3, 5)),  # non-cubic
    ((1, 8, 4, 8, 16), (5, 1, 3)),
]
V1_3D = [
    ((1, 8, 8, 8, 8), (3, 3, 3)),
    ((2, 16, 8, 8, 4), (3, 3, 3)),
    ((1, 8, 8, 16, 8), (1, 3, 3)),
    ((1, 8, 8, 8, 8), (3, 1, 1)),
    ((1, 4, 4, 6, 48), (3, 3, 3)),  # 128 % C != 0: the packed kernel refuses it
]
PACKED_2D = [
    ((1, 8, 16, 32), (3, 3)),
    ((2, 12, 16, 16), (5, 3)),
    ((1, 16, 8, 16), (7, 7)),
]


def _inputs(shape, ks, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    w = rs.randn(shape[0], math.prod(ks), shape[-1]).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    return x, w, g


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rtol * np.abs(want).max())


def _jax_kernels(shape, ks):
    """``(forward, dw, flip)`` of the JAX kernel that takes this case, in interpret mode."""
    if len(shape) == 4:
        assert dpk.supports_packed_2d(shape, ks)
        b, s1, s2, c = shape
        vol = (b, 1, s1, s2, c)
        return (lambda x, w: dpk.depthwise_conv2d_packed(x, w, ks),
                lambda x, g: dpk._dw_impl(x.reshape(vol), g.reshape(vol), (1, *ks)),
                lambda w: dpk._flip_taps(w, (1, *ks)))
    if dpk.supports_packed(shape, ks):
        return (lambda x, w: dpk._fwd_impl(x, w, ks), lambda x, g: dpk._dw_impl(x, g, ks),
                lambda w: dpk._flip_taps(w, ks))
    assert v1.supports_depthwise(shape, ks)
    return (lambda x, w: v1._fwd_impl(x, w, ks), lambda x, g: v1._dw_impl(x, g, ks),
            lambda w: v1._flip_taps(w, ks))


@pytest.mark.parametrize("shape,ks", PACKED_3D + V1_3D + PACKED_2D)
def test_forward_matches_jax_kernel(shape, ks):
    """y against the Pallas forward (packed, v1 or the 2-D entry point), 1e-5 of the largest entry."""
    if shape[-1] == 48:
        assert not dpk.supports_packed(shape, ks)
    x, w, _ = _inputs(shape, ks)
    fwd, _, _ = _jax_kernels(shape, ks)
    y = depthwise_conv(torch.from_numpy(x), torch.from_numpy(w), ks)
    assert y.shape == x.shape and y.dtype == torch.float32
    _close(y, fwd(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("shape,ks", PACKED_3D[1:3] + V1_3D[3:] + PACKED_2D[1:])
def test_gradients_match_jax_kernels(shape, ks):
    """dx (the forward on flipped taps) and dw against the Pallas kernels; autograd agrees with both by name."""
    x, w, g = _inputs(shape, ks, seed=1)
    fwd, dw_fn, flip = _jax_kernels(shape, ks)
    dx_j = fwd(jnp.asarray(g), flip(jnp.asarray(w)))
    dw_j = dw_fn(jnp.asarray(x), jnp.asarray(g))
    xt, wt, gt = (torch.from_numpy(a) for a in (x, w, g))
    _close(depthwise_conv(gt, flip_taps(wt, ks), ks), dx_j)
    dw = depthwise_conv_dw(xt, gt, ks)
    assert dw.shape == w.shape and dw.dtype == torch.float32
    _close(dw, dw_j)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    dx_a, dw_a = torch.autograd.grad(depthwise_conv(xt, wt, ks), (xt, wt), gt)
    _close(dx_a, dx_j)
    _close(dw_a, dw_j)
    _close(depthwise_conv_dw_plain(xt.detach(), gt, ks), dw_j)


@pytest.mark.parametrize("entry,shape,ks", [
    ("packed3d", (1, 8, 8, 16, 32), (3, 3, 3)),
    ("packed2d", (2, 8, 16, 32), (3, 3)),
    ("v1", (1, 8, 8, 8, 4), (3, 3, 3)),
])
def test_custom_vjp_entry_points(entry, shape, ks):
    """Gradients of sum(y^2) through the JAX ``custom_vjp`` entry points and through the port's autograd."""
    fn = {"packed3d": dpk.depthwise_conv3d_packed, "packed2d": dpk.depthwise_conv2d_packed, "v1": v1.depthwise_conv3d}[entry]
    x, w, _ = _inputs(shape, ks, seed=2)
    gx, gw = jax.grad(lambda a, b: jnp.sum(fn(a, b, ks) ** 2), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    depthwise_conv(xt, wt, ks).square().sum().backward()
    _close(xt.grad, gx, 1e-4)  # the cotangent 2y is itself a rounded sum
    _close(wt.grad, gw, 1e-4)


def test_tap_order_and_orientation():
    """One tap set to one copies the input shifted by that tap's offset: row-major taps, cross-correlation."""
    ks, shape = (1, 3, 5), (1, 2, 4, 6, 2)
    x = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    for t, off in enumerate(np.ndindex(*ks)):
        w = torch.zeros(1, 15, 2)
        w[0, t] = 1.0
        d = [o - k // 2 for o, k in zip(off, ks)]
        want = torch.zeros_like(x)
        for i2 in range(4):
            for i3 in range(6):
                j2, j3 = i2 + d[1], i3 + d[2]
                if 0 <= j2 < 4 and 0 <= j3 < 6:
                    want[0, :, i2, i3] = x[0, :, j2, j3]
        assert torch.equal(depthwise_conv(x, w, ks), want), (t, off)


@pytest.mark.parametrize("shape,ks", [((2, 4, 6, 8, 8), (3, 3, 3)), ((2, 8, 8, 16), (7, 7))])
def test_bfloat16_in_and_out(shape, ks):
    """bf16 activations: f32 arithmetic and one rounding of y, so within one bf16 ulp (2^-7 of the largest
    entry) of the f32 result on the same rounded inputs; dw stays f32."""
    x, w, g = _inputs(shape, ks, seed=3)
    xb, gb = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    y = depthwise_conv(xb, torch.from_numpy(w), ks)
    assert y.dtype == torch.bfloat16
    _close(y.float(), depthwise_conv(xb.float(), torch.from_numpy(w), ks).numpy(), 2.0**-7)
    dw = depthwise_conv_dw(xb, gb, ks)
    assert dw.dtype == torch.float32
    _close(dw, depthwise_conv_dw(xb.float(), gb.float(), ks).numpy())


def test_float64_stays_float64():
    """The plain version keeps float64, for the semantic checks of the layers above it."""
    x, w, _ = _inputs((1, 4, 4, 4, 3), (3, 3, 3), seed=4)
    y = depthwise_conv(torch.from_numpy(x).double(), torch.from_numpy(w).double(), (3, 3, 3))
    assert y.dtype == torch.float64
    _close(y.float(), depthwise_conv_plain(torch.from_numpy(x), torch.from_numpy(w), (3, 3, 3)).numpy())


def test_refusals():
    """Even kernel sizes, a wrong rank and mis-shaped taps raise; a tensor on another device than CPU or CUDA too."""
    x = torch.zeros(1, 4, 4, 4, 2)
    with pytest.raises(ValueError, match="odd"):
        depthwise_conv(x, torch.zeros(1, 12, 2), (2, 3, 2))
    with pytest.raises(ValueError, match="kernel size per spatial axis"):
        depthwise_conv(x, torch.zeros(1, 9, 2), (3, 3))
    with pytest.raises(ValueError, match="taps of shape"):
        depthwise_conv(x, torch.zeros(1, 9, 2), (3, 3, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        depthwise_conv(torch.empty(1, 4, 4, 4, 2, device="meta"), torch.empty(1, 27, 2, device="meta"), (3, 3, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        depthwise_conv_dw(torch.empty(1, 4, 4, 2, device="meta"), torch.empty(1, 4, 4, 2, device="meta"), (3, 3))
