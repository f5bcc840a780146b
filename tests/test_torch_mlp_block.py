"""Port parity: K2's plain version, forward and gradients, against the JAX pre-norm MLP chain and ``fused_prenorm_mlp``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu.ops.pallas.mlp_block import fused_prenorm_mlp

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.ops.kernels import (
    prenorm_mlp,
    prenorm_mlp_backward,
    prenorm_mlp_backward_plain,
    prenorm_mlp_plain,
)

torch.set_num_threads(1)

EPS = 1e-5


def _params(c, h, seed=0):
    """JAX-layout parameters: gamma, beta (C,), w1 (C, H), b1 (H,), w2 (H, C), b2 (C,)."""
    rng = np.random.default_rng(seed)
    return (
        (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32),
        (0.2 * rng.standard_normal((c, h))).astype(np.float32),
        (0.1 * rng.standard_normal(h)).astype(np.float32),
        (0.2 * rng.standard_normal((h, c))).astype(np.float32),
        (0.1 * rng.standard_normal(c)).astype(np.float32),
    )


def _torch_params(params):
    """The same parameters in torch nn.Linear layouts: w1 (H, C), w2 (C, H)."""
    g, b, w1, b1, w2, b2 = (torch.from_numpy(p) for p in params)
    return g, b, w1.T.contiguous(), b1, w2.T.contiguous(), b2


def _x(shape, seed=1):
    return (2.0 * np.random.default_rng(seed).standard_normal(shape) + 0.5).astype(np.float32)


@pytest.mark.parametrize("c,ratio", [(8, 4), (16, 4), (32, 2)])
def test_plain_matches_unfused_jax_chain_f32(c, ratio):
    """f32 against JAX's LayerNorm + MLP modules (flax's E[x^2]-E[x]^2 variance): rtol 1e-5, atol 2e-5."""
    h = c * ratio
    x = _x((2, 4, 4, 4, c))
    params = _params(c, h)
    g, b, w1, b1, w2, b2 = params
    norm, mlp = ftx.LayerNorm(c, eps=EPS), ftx.MLP(c, ratio=ratio)
    vn = {"params": {"norm": {"scale": g, "bias": b}}}
    vm = {"params": {"fc1": {"linear": {"kernel": w1, "bias": b1}}, "fc2": {"linear": {"kernel": w2, "bias": b2}}}}
    xj = jnp.asarray(x)
    y_j = np.asarray(xj + mlp.apply(vm, norm.apply(vn, xj)))
    y_t = prenorm_mlp_plain(torch.from_numpy(x), *_torch_params(params), eps=EPS)
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-5, atol=2e-5)


def test_plain_matches_port_module_chain():
    """The plain version is the port's own LayerNorm -> MLP chain plus the residual (1e-6)."""
    c = 16
    gen = torch.Generator().manual_seed(0)
    norm, mlp = ftt.LayerNorm(c), ftt.MLP(c, ratio=4, generator=gen)
    x = torch.from_numpy(_x((3, 5, c)))
    ln, fc1, fc2 = norm.norm, mlp.fc1.linear, mlp.fc2.linear
    with torch.no_grad():
        y_chain = x + mlp(norm(x))
        y_plain = prenorm_mlp_plain(x, ln.weight, ln.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias)
    np.testing.assert_allclose(y_plain.numpy(), y_chain.numpy(), rtol=1e-6, atol=1e-6)


def test_plain_bf16_matches_fused_jax_kernel():
    """bf16 against the interpret-mode Pallas kernel.

    The plain version keeps f32 inside and rounds only the output.  The
    kernel also rounds the normalised tokens and the GELU outputs to bf16
    before its products, and its tanh-composite GELU is <= 4.9e-5 from erf.
    Tolerance: rtol 2**-7 (one bf16 ulp of the output) and atol 0.05 for the
    kernel's inner bf16 roundings, summed over the hidden width.
    """
    c, h = 32, 128
    params = _params(c, h, seed=2)
    x = _x((2, 8, 8, 8, c), seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    y_j = fused_prenorm_mlp(xb, *(jnp.asarray(p) for p in params), eps=EPS)
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16()
    y_t = prenorm_mlp_plain(xt, *_torch_params(params), eps=EPS)
    assert y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(y_t.float().numpy(), np.asarray(y_j.astype(jnp.float32)), rtol=2**-7, atol=0.05)


def test_wrapper_on_cpu_is_plain():
    """A CPU tensor goes to the plain version: bit-identical results, no launch counted."""
    c = 32
    args = (torch.from_numpy(_x((4, 6, c))), *_torch_params(_params(c, 4 * c)))
    before = prenorm_mlp.launches
    np.testing.assert_array_equal(prenorm_mlp(*args).numpy(), prenorm_mlp_plain(*args).numpy())
    assert prenorm_mlp.launches == before


GRAD_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


def _to_jax_layout(grads):
    """The port's gradients (torch layouts) as numpy arrays in the JAX layouts: dw1 (C, H), dw2 (H, C)."""
    dx, dg, db, dw1, db1, dw2, db2 = (t.float().numpy() for t in grads)
    return dx, dg, db, dw1.T, db1, dw2.T, db2


@pytest.mark.parametrize("c,ratio", [(8, 4), (16, 4), (32, 2)])
def test_plain_gradients_match_unfused_jax_chain_f32(c, ratio):
    """dx and the six parameter gradients for a random cotangent against jax.vjp of LayerNorm + MLP.

    f32; rtol 1e-4 and atol 1e-5 of each gradient's largest entry (flax's
    E[x^2]-E[x]^2 variance and the sums over 128 tokens in another order).
    """
    h = c * ratio
    x = _x((2, 4, 4, 4, c))
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    params = _params(c, h)
    norm, mlp = ftx.LayerNorm(c, eps=EPS), ftx.MLP(c, ratio=ratio)

    def chain(xj, gam, bet, w1, b1, w2, b2):
        vn = {"params": {"norm": {"scale": gam, "bias": bet}}}
        vm = {"params": {"fc1": {"linear": {"kernel": w1, "bias": b1}}, "fc2": {"linear": {"kernel": w2, "bias": b2}}}}
        return xj + mlp.apply(vm, norm.apply(vn, xj))

    want = jax.vjp(chain, jnp.asarray(x), *(jnp.asarray(p) for p in params))[1](jnp.asarray(g))
    got = _to_jax_layout(prenorm_mlp_backward_plain(torch.from_numpy(x), torch.from_numpy(g), *_torch_params(params), eps=EPS))
    for name, a, b in zip(GRAD_NAMES, got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_plain_gradients_bf16_match_fused_jax_kernel():
    """bf16 against the custom VJP of the interpret-mode Pallas kernel, by the kernel's own yardstick.

    The JAX backward kernel rounds the normalised tokens, the GELU outputs and
    dh to bf16 before its products and uses a tanh-composite GELU'; the plain
    version keeps f32 inside and rounds only dx.  Parameter gradients are sums
    of those per-token terms over 1024 tokens, so the two drift apart like
    sqrt(tokens) bf16 ulps: ``tests/test_mlp_kernel.py`` accepts 2e-2 of the
    largest entry between the kernel and a full-f32 oracle, and the plain
    version is that oracle, so the same 2e-2 holds here (3e-2 for dx, which
    adds the output's own bf16 rounding, 2^-8).
    """
    c, h = 32, 128
    params = _params(c, h, seed=2)
    x = _x((2, 8, 8, 8, c), seed=3)
    g = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    xb, gb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    fn = lambda *a: fused_prenorm_mlp(*a, eps=EPS)
    want = jax.vjp(fn, xb, *(jnp.asarray(p) for p in params))[1](gb)
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16()
    gt = torch.tensor(np.asarray(gb.astype(jnp.float32))).bfloat16()
    grads = prenorm_mlp_backward_plain(xt, gt, *_torch_params(params), eps=EPS)
    assert grads[0].dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in grads[1:])
    for name, a, b in zip(GRAD_NAMES, _to_jax_layout(grads), want):
        b = np.asarray(b.astype(jnp.float32))
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= (3e-2 if name == "dx" else 2e-2), (name, err)


def test_wrapper_gradient_on_cpu_is_plain():
    """Autograd through the wrapper on the CPU equals prenorm_mlp_backward, leaf for leaf; no launch counted."""
    c = 32
    x = torch.from_numpy(_x((4, 6, c)))
    g = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 6, c)).astype(np.float32))
    params = _torch_params(_params(c, 4 * c))
    leaves = [t.clone().requires_grad_(True) for t in (x, *params)]
    before = prenorm_mlp_backward.launches
    prenorm_mlp(*leaves).backward(g)
    want = prenorm_mlp_backward(x, g, *params)
    for name, leaf, w in zip(GRAD_NAMES, leaves, want):
        np.testing.assert_array_equal(leaf.grad.numpy(), w.numpy(), err_msg=name)
    assert prenorm_mlp_backward.launches == before

