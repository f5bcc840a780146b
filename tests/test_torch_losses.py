"""Port parity: the segmentation losses against ``factorizer_tpu.train.losses`` on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorizer_tpu.train import losses as jl

from factorizer_tpu_torch.train import losses as tl

torch.set_num_threads(1)


def _case(shape=(2, 3, 8, 8, 8), seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal(shape)).astype(dtype)
    targets = (rng.random(shape) > 0.6).astype(dtype)
    return logits, targets


LOSSES = {
    "dice": ("dice_loss", {}),
    "dice_plain_pred": ("dice_loss", {"squared_pred": False, "include_background": False}),
    "bce": ("bce_with_logits", {}),
    "dice_ce": ("dice_ce_loss", {}),
    "dice_ce_weighted": ("dice_ce_loss", {"lambda_dice": 0.3, "lambda_ce": 1.7, "smooth_nr": 1e-3}),
}


@pytest.mark.parametrize("case", list(LOSSES))
def test_loss_matches_jax_f32(case):
    """f32 against the JAX loss: rtol 1e-6 (the sums over 1536 voxels run in another order)."""
    name, kw = LOSSES[case]
    logits, targets = _case()
    want = float(getattr(jl, name)(jnp.asarray(logits), jnp.asarray(targets), **kw))
    got = getattr(tl, name)(torch.from_numpy(logits), torch.from_numpy(targets), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


@pytest.mark.parametrize("case", list(LOSSES))
def test_loss_matches_jax_f64(case):
    """f64 stays f64 and agrees to 1e-12."""
    name, kw = LOSSES[case]
    logits, targets = _case(seed=1, dtype=np.float64)
    with jax.enable_x64(True):
        want = float(getattr(jl, name)(jnp.asarray(logits), jnp.asarray(targets), **kw))
    got = getattr(tl, name)(torch.from_numpy(logits), torch.from_numpy(targets), **kw)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), want, rtol=1e-12)


def test_dice_ce_gradient_matches_jax():
    """d loss / d logits in f32: rtol 1e-5, atol 1e-9 (entries are ~1e-4, one per voxel)."""
    logits, targets = _case(seed=2)
    want = np.asarray(jax.grad(jl.dice_ce_loss)(jnp.asarray(logits), jnp.asarray(targets)))
    x = torch.from_numpy(logits).requires_grad_(True)
    tl.dice_ce_loss(x, torch.from_numpy(targets)).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5, atol=1e-9)


def test_bf16_logits_give_f32_loss():
    """bf16 logits (amp) are lifted to f32 before any reduction, as in JAX: same value to 1e-6."""
    logits, targets = _case(seed=3)
    lb = jnp.asarray(logits, jnp.bfloat16)
    want = jl.dice_ce_loss(lb, jnp.asarray(targets))
    got = tl.dice_ce_loss(torch.tensor(np.asarray(lb.astype(jnp.float32))).bfloat16(), torch.from_numpy(targets))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("dims", [3, 2])
@pytest.mark.parametrize("weights", [None, (1.0, 0.25, 0.5)])
def test_deep_supervision_loss_matches_jax(dims, weights):
    """Three heads at 1, 1/2 and 1/4 resolution, targets average-pooled: f32 rtol 1e-6, f64 1e-12."""
    full = (8,) * dims
    rng = np.random.default_rng(4)
    for dtype, rtol in ((np.float32, 1e-6), (np.float64, 1e-12)):
        targets = (rng.random((2, 3, *full)) > 0.5).astype(dtype)
        pyramid = [rng.standard_normal((2, 3, *(s // f for s in full))).astype(dtype) for f in (1, 2, 4)]
        with jax.enable_x64(dtype == np.float64):
            want = float(jl.deep_supervision_loss([jnp.asarray(p) for p in pyramid], jnp.asarray(targets), weights))
        got = tl.deep_supervision_loss([torch.from_numpy(p) for p in pyramid], torch.from_numpy(targets), weights)
        assert got.dtype == torch.from_numpy(targets).dtype
        np.testing.assert_allclose(got.item(), want, rtol=rtol)
