"""Port parity for the blind-deconvolution layer and the norms it sits between.

``batched_conv``, ``sconv``, ``Deconv`` (forward and gradients w.r.t. the
input, ``h0`` and the linear head), ``InstanceNorm`` and ``GroupNorm`` against
the JAX package on the CPU, where the port's depthwise route takes K3's plain
version and JAX its ``lax`` path.  Inputs and weights come from numpy seeds.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu.factorization import deconv as jdeconv

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.factorization import deconv as pdeconv
from factorizer_tpu_torch.ops.kernels import depthwise_conv as k3

torch.set_num_threads(1)


def _np(t):
    return t.detach().numpy()


def _close(got, want, rtol, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30), err_msg=err_msg)


# ---- batched_conv / sconv ---------------------------------------------------

CONV_CASES = {
    "depthwise3d": ((2, 6, 5, 4, 6), 6, 6, (3, 3, 3)),   # K3's route
    "depthwise2d": ((2, 9, 8, 4), 4, 4, (7, 7)),         # K3's route, 2-D
    "grouped": ((2, 6, 5, 4, 8), 12, 4, (3, 3, 3)),      # 1 < groups < C
    "dense": ((2, 6, 5, 4, 3), 5, 1, (3, 1, 3)),
    "expanding": ((2, 6, 6, 4), 8, 4, (3, 5)),           # groups == C_in, two outputs per group: not depthwise
}


@pytest.mark.parametrize("case", CONV_CASES)
def test_batched_conv_matches_jax(case, monkeypatch):
    """Every grouping against ``lax.conv_general_dilated`` under vmap: 1e-5 of the largest entry (f32 sums)."""
    shape, c_out, groups, ks = CONV_CASES[case]
    rs = np.random.RandomState(0)
    s = rs.randn(*shape).astype(np.float32)
    h = rs.randn(shape[0], c_out, shape[-1] // groups, *ks).astype(np.float32)
    pad = tuple((k // 2, k // 2) for k in ks)
    calls = []
    monkeypatch.setattr(pdeconv, "depthwise_conv", lambda *a: calls.append(1) or k3(*a))
    y = pdeconv.batched_conv(torch.from_numpy(s), torch.from_numpy(h), pad, groups)
    assert bool(calls) == case.startswith("depthwise")
    _close(y, jdeconv.batched_conv(jnp.asarray(s), jnp.asarray(h), pad, groups), 1e-5)


def test_batched_conv_uneven_padding():
    """Padding other than k // 2 leaves the depthwise route: the output shrinks or grows as JAX's does."""
    rs = np.random.RandomState(1)
    s, h = rs.randn(1, 6, 6, 4).astype(np.float32), rs.randn(1, 4, 1, 3, 3).astype(np.float32)
    pad = ((0, 1), (2, 0))
    y = pdeconv.batched_conv(torch.from_numpy(s), torch.from_numpy(h), pad, 4)
    want = jdeconv.batched_conv(jnp.asarray(s), jnp.asarray(h), pad, 4)
    assert tuple(y.shape) == want.shape == (1, 5, 6, 4)
    _close(y, want, 1e-5)


@pytest.mark.parametrize("shape,ca,cb,ks", [((2, 6, 5, 4), 3, 2, (3, 3, 3)), ((2, 8, 7), 2, 4, (7, 5))])
def test_sconv_matches_jax(shape, ca, cb, ks):
    """Channel-by-channel correlation over the whole spatial extent, ``(B, Ca, Cb, *k)``: 1e-5 of the largest entry."""
    rs = np.random.RandomState(2)
    a = rs.randn(*shape, ca).astype(np.float32)
    b = rs.randn(*shape, cb).astype(np.float32)
    pad = tuple((k // 2, k // 2) for k in ks)
    y = pdeconv.sconv(torch.from_numpy(a), torch.from_numpy(b), pad)
    assert tuple(y.shape) == (2, ca, cb, *ks)
    _close(y, jdeconv.sconv(jnp.asarray(a), jnp.asarray(b), pad), 1e-5)


# ---- Deconv -------------------------------------------------------------------

DECONV_CASES = {
    # name: (input shape, Deconv keyword arguments)
    "bundle3d": ((2, 6, 6, 6, 8), dict(kernel_size=(3, 3, 3), groups=-1, ratio=1, num_iters=1)),
    "bundle2d": ((2, 10, 12, 8), dict(kernel_size=(7, 7), groups=-1, ratio=1, num_iters=1)),
    "default": ((2, 6, 6, 6, 16), dict(kernel_size=(3, 3, 3))),  # groups 8, ratio 4, 2 iterations
    "filter": ((2, 6, 6, 6, 8), dict(kernel_size=(3, 3, 3), groups=2, ratio=2, update_filter=True)),
    "truncated": ((2, 6, 6, 6, 8), dict(kernel_size=(3, 3, 3), groups=-1, ratio=1, num_iters=3, num_grad_iters=1)),
    "noncubic": ((1, 4, 6, 8, 4), dict(kernel_size=(1, 3, 5), groups=-1, ratio=1, num_iters=2)),
}


def _deconv_pair(shape, kwargs, seed=0, dtype=None, zero_region=False):
    """The JAX layer, its parameters (numpy), the port's layer carrying them, and an input."""
    c = shape[-1]
    rs = np.random.RandomState(seed)
    x = np.maximum(rs.randn(*shape), 0).astype(np.float32)  # the mixer feeds relu(in_proj(.))
    if zero_region:
        x[:, : shape[1] // 2] = 0.0
    jdt = {None: None, torch.bfloat16: jnp.bfloat16}[dtype]
    layer_j = ftx.Deconv(channels=c, dtype=jdt, **kwargs)
    params = jax.tree.map(np.array, flax.core.unfreeze(layer_j.init(jax.random.key(seed), jnp.asarray(x))["params"]))
    layer_t = ftt.Deconv(c, dtype=dtype, device="cpu", generator=torch.Generator().manual_seed(seed), **kwargs)
    assert tuple(layer_t.init.h0.shape) == params["h0"].shape
    layer_t.load_state_dict({
        "init.h0": torch.from_numpy(params["h0"]),
        "init.linear.linear.weight": torch.from_numpy(np.ascontiguousarray(params["linear"]["linear"]["kernel"].T)),
        "init.linear.linear.bias": torch.from_numpy(params["linear"]["linear"]["bias"]),
    })
    return layer_j, params, layer_t, x


def _jax_grads(layer_j, params, x, g, dtype=jnp.float32):
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)

    def f(p, xx):
        return jnp.sum(layer_j.apply({"params": p}, xx) * jnp.asarray(g, dtype))

    y = layer_j.apply({"params": params}, jnp.asarray(x, dtype))
    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x, dtype))
    return y, gx, gp


def _port_grads(layer_t, x, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer_t(xt)
    (y * torch.from_numpy(g)).sum().backward()
    lin = layer_t.init.linear.linear
    # a parameter that no differentiated iteration reads has no gradient here and a zero one in JAX
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in (layer_t.init.h0, lin.weight, lin.bias)]
    return y, xt.grad, {"h0": grads[0], "kernel": grads[1].T, "bias": grads[2]}


@pytest.mark.parametrize("case", DECONV_CASES)
def test_deconv_forward_and_gradients_match_jax(case):
    """f32: the source to 1e-5 and the gradients w.r.t. x, h0 and the linear head to 1e-3 of their largest
    entry (quotients of convolutions, up to three iterations deep, summed in another order)."""
    shape, kwargs = DECONV_CASES[case]
    layer_j, params, layer_t, x = _deconv_pair(shape, kwargs)
    g = np.random.RandomState(9).randn(*layer_j.apply({"params": params}, jnp.asarray(x)).shape).astype(np.float32)
    y_j, gx_j, gp_j = _jax_grads(layer_j, params, x, g)
    y_t, gx_t, gp_t = _port_grads(layer_t, x, g)
    assert y_t.dtype == torch.float32 and tuple(y_t.shape) == y_j.shape
    _close(y_t, y_j, 1e-5)
    _close(gx_t, gx_j, 1e-3, "dx")
    _close(gp_t["h0"], gp_j["h0"], 1e-3, "h0")
    _close(gp_t["kernel"], gp_j["linear"]["linear"]["kernel"], 1e-3, "linear kernel")
    _close(gp_t["bias"], gp_j["linear"]["linear"]["bias"], 1e-3, "linear bias")
    if kwargs.get("num_grad_iters") == 1:
        assert gx_t.abs().max() > 0


@pytest.mark.parametrize("case", ["bundle3d", "bundle2d", "truncated"])
def test_deconv_zero_region_matches_jax_f32_and_f64(case):
    """Half the input all zero (BraTS background after the ReLU): numerator and denominator are both eps
    there and cotangents pass through eps / eps quotients.  f64 agrees to 1e-10; f32 stays finite and within
    1e-3 of JAX's f32 (forward 1e-5)."""
    shape, kwargs = DECONV_CASES[case]
    layer_j, params, layer_t, x = _deconv_pair(shape, kwargs, seed=3, zero_region=True)
    g = np.random.RandomState(4).randn(*shape).astype(np.float32)
    y_j, gx_j, gp_j = _jax_grads(layer_j, params, x, g)
    y_t, gx_t, gp_t = _port_grads(layer_t, x, g)
    assert torch.isfinite(gx_t).all() and torch.isfinite(gp_t["h0"]).all()
    _close(y_t, y_j, 1e-5)
    _close(gx_t, gx_j, 1e-3, "dx")
    _close(gp_t["h0"], gp_j["h0"], 1e-3, "h0")
    with jax.enable_x64(True):
        y_j, gx_j, gp_j = _jax_grads(layer_j, params, x.astype(np.float64), g.astype(np.float64), jnp.float64)
        y_j, gx_j, gp_j = jax.tree.map(np.asarray, (y_j, gx_j, gp_j))
    layer_t.double()
    for p in layer_t.parameters():
        p.grad = None
    y_t, gx_t, gp_t = _port_grads(layer_t, x.astype(np.float64), g.astype(np.float64))
    assert y_t.dtype == torch.float64 and y_j.dtype == np.float64
    _close(y_t, y_j, 1e-12)
    _close(gx_t, gx_j, 1e-10, "dx")
    _close(gp_t["h0"], gp_j["h0"], 1e-10, "h0")
    _close(gp_t["kernel"], gp_j["linear"]["linear"]["kernel"], 1e-10, "linear kernel")


def test_deconv_bfloat16_solves_in_float32():
    """The bf16 layer: a bf16 head, the updates in f32, a bf16 source.  Against JAX's bf16 layer within 2e-2
    of the largest entry (the head's bf16 product rounds at other places in the two frameworks)."""
    shape, kwargs = DECONV_CASES["bundle3d"]
    layer_j, params, layer_t, x = _deconv_pair(shape, kwargs, seed=5, dtype=torch.bfloat16)
    xb = torch.from_numpy(x).bfloat16()
    seen = []
    update = layer_t.update_s
    layer_t.update_s = lambda a, s, h: seen.append((a.dtype, s.dtype, h.dtype)) or update(a, s, h)
    y_t = layer_t(xb)
    assert seen == [(torch.float32,) * 3] and y_t.dtype == torch.bfloat16
    y_j = layer_j.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    assert y_j.dtype == jnp.bfloat16
    _close(y_t.float(), np.asarray(y_j.astype(jnp.float32)), 2e-2)


def test_deconv_fit_reconstruct_loss_and_normalize():
    """fit, reconstruct, loss (a vector over batch x groups) and normalize_h against JAX: 1e-5."""
    shape, kwargs = DECONV_CASES["filter"]
    layer_j, params, layer_t, x = _deconv_pair(shape, kwargs, seed=6)
    v = {"params": params}
    s_j, h_j = layer_j.apply(v, jnp.asarray(x), method="fit")
    s_t, h_t = layer_t.fit(torch.from_numpy(x))
    _close(s_t, s_j, 1e-5)
    _close(h_t, h_j, 1e-5)
    _close(layer_t.reconstruct(s_t, h_t), layer_j.apply(v, s_j, h_j, method="reconstruct"), 1e-5)
    loss_t = layer_t.loss(torch.from_numpy(x), s_t, h_t)
    assert tuple(loss_t.shape) == (shape[0] * 2,)
    _close(loss_t, layer_j.apply(v, jnp.asarray(x), s_j, h_j, method="loss"), 1e-5)
    _close(layer_t.normalize_h(h_t), layer_j.apply(v, h_j, method="normalize_h"), 1e-5)
    s0_t, h0_t = layer_t.initialize(torch.from_numpy(x))
    s0_j, h0_j = layer_j.apply(v, jnp.asarray(x), method="initialize")
    _close(s0_t, s0_j, 1e-5)
    _close(h0_t, h0_j, 1e-6)


# ---- norms --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 6, 5, 4, 8), (2, 9, 7, 8)], ids=["3d", "2d"])
def test_instance_norm_matches_jax(shape, dtype):
    """Per-sample per-channel normalisation, no parameters: 1e-5 in f32; bf16 in and out with f32 statistics,
    one bf16 ulp (2^-7 of the largest entry)."""
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 3 + 2).astype(np.float32)
    jdt = None if dtype is None else jnp.bfloat16
    norm_j = ftx.InstanceNorm(shape[-1], dtype=jdt)
    xj = jnp.asarray(x) if dtype is None else jnp.asarray(x, jnp.bfloat16)
    variables = norm_j.init(jax.random.key(0), xj)
    assert not jax.tree.leaves(variables)
    norm_t = ftt.InstanceNorm(shape[-1], dtype=dtype, device="cpu")
    assert not norm_t.state_dict()
    xt = torch.from_numpy(x) if dtype is None else torch.from_numpy(x).bfloat16()
    y_t, y_j = norm_t(xt), norm_j.apply(variables, xj)
    assert y_t.dtype == (dtype or torch.float32) and y_j.dtype == (jdt or jnp.float32)
    _close(y_t.float(), np.asarray(y_j.astype(jnp.float32)), 1e-5 if dtype is None else 2.0**-7)


def test_instance_norm_at_stage0_extent():
    """128^3 voxels per channel, mean 5 and deviation 1: flax takes E[x^2] - E[x]^2 in f32, the port centres
    first, and the two differ by 2e-4 of the largest entry at most (the f32 rounding of E[x^2] ~ 26 against a
    variance of 1, about 26 * 2^-24 relative in the variance, plus f32 sums over 2.1 M terms in another order)."""
    rs = np.random.RandomState(1)
    x = (rs.randn(1, 128, 128, 128, 2) + 5).astype(np.float32)
    y_j = ftx.InstanceNorm(2).apply({}, jnp.asarray(x))
    y_t = ftt.InstanceNorm(2, device="cpu")(torch.from_numpy(x))
    x64 = x.astype(np.float64)
    exact = (x64 - x64.mean((1, 2, 3), keepdims=True)) / np.sqrt(x64.var((1, 2, 3), keepdims=True) + 1e-5)
    _close(y_t, y_j, 2e-4)
    _close(y_t, exact, 1e-5)  # the port's own error is the smaller part


def test_instance_norm_affine_and_group_norm_match_jax():
    """With affine parameters, and GroupNorm with 2 groups: scale and bias carried across, 1e-5; gradients of
    a weighted sum w.r.t. input and parameters, 1e-4."""
    rs = np.random.RandomState(2)
    x = (rs.randn(2, 5, 4, 3, 8) + 1).astype(np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    scale, bias = rs.rand(8).astype(np.float32) + 0.5, rs.randn(8).astype(np.float32)
    pairs = [
        (ftx.InstanceNorm(8, affine=True), ftt.InstanceNorm(8, affine=True, device="cpu")),
        (ftx.GroupNorm(2, 8), ftt.GroupNorm(2, 8, device="cpu")),
    ]
    for norm_j, norm_t in pairs:
        params = {"norm": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
        norm_t.load_state_dict({"norm.weight": torch.from_numpy(scale), "norm.bias": torch.from_numpy(bias)})
        xt = torch.from_numpy(x).requires_grad_(True)
        y_t = norm_t(xt)
        _close(y_t, norm_j.apply({"params": params}, jnp.asarray(x)), 1e-5)
        (y_t * torch.from_numpy(g)).sum().backward()
        gp, gx = jax.grad(lambda p, a: jnp.sum(norm_j.apply({"params": p}, a) * g), argnums=(0, 1))(params, jnp.asarray(x))
        _close(xt.grad, gx, 1e-4)
        _close(norm_t.norm.weight.grad, gp["norm"]["scale"], 1e-4)
        _close(norm_t.norm.bias.grad, gp["norm"]["bias"], 1e-4)


def test_resolve_activation():
    """Names, None and callables, as far as the Deconver needs them."""
    x = torch.tensor([-1.0, 2.0])
    assert torch.equal(ftt.layers.resolve_activation("relu")(x), torch.tensor([0.0, 2.0]))
    assert torch.equal(ftt.layers.resolve_activation(None)(x), x)
    assert ftt.layers.resolve_activation(torch.tanh) is torch.tanh
    assert torch.equal(ftt.layers.resolve_activation("identity")(x), x)
    with pytest.raises(KeyError):
        ftt.layers.resolve_activation("swish7")
    with pytest.raises(TypeError):
        ftt.layers.resolve_activation(3)
