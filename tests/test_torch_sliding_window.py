"""Port parity: sliding-window positions, importance map, blended inference and the ensemble."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorizer_tpu.train import sliding_window as sw_jax

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.train import sliding_window as sw_torch

torch.set_num_threads(1)

W = np.random.default_rng(0).standard_normal((3, 2)).astype(np.float32)


def _predict_jax(windows):
    """A small window-dependent model: a channel map scaled by the window's mean."""
    return jnp.tanh(jnp.einsum("oc,nc...->no...", W, windows) * windows.mean(axis=(1, 2, 3, 4), keepdims=True))


def _predict_torch(windows):
    return torch.tanh(torch.einsum("oc,nc...->no...", torch.from_numpy(W), windows)
                      * windows.mean(dim=(1, 2, 3, 4), keepdim=True))


@pytest.mark.parametrize(
    "image,roi,overlap",
    [((240, 240, 155), (128, 128, 128), 0.5), ((20, 18, 12), (8, 8, 8), 0.25), ((5, 18, 8), (8, 8, 8), 0.5)],
)
def test_positions_match_jax(image, roi, overlap):
    assert sw_torch.sliding_window_positions(image, roi, overlap) == sw_jax.sliding_window_positions(image, roi, overlap)


def test_bundle_window_count():
    """A BraTS-native (240, 240, 155) volume at roi 128^3, overlap 0.5 takes 3 x 3 x 2 windows."""
    assert len(sw_torch.sliding_window_positions((240, 240, 155), (128,) * 3, 0.5)) == 18


@pytest.mark.parametrize("roi", [(16, 12, 8), (128, 128, 128)])
def test_importance_map_matches_jax(roi):
    np.testing.assert_array_equal(sw_torch.compute_importance_map(roi), sw_jax.compute_importance_map(roi))


@pytest.mark.parametrize("shape,sw_batch", [((1, 2, 20, 18, 12), 3), ((2, 2, 6, 18, 12), 4)])
def test_inference_matches_jax(shape, sw_batch):
    """Blended predictions agree to f32 rounding (1e-6); includes a ragged last group and padding."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    y_j = sw_jax.sliding_window_inference(jnp.asarray(x), (8, 8, 8), _predict_jax, sw_batch_size=sw_batch, overlap=0.5)
    y_t = sw_torch.sliding_window_inference(torch.from_numpy(x), (8, 8, 8), _predict_torch, sw_batch_size=sw_batch,
                                            overlap=0.5)
    assert y_t.shape == (shape[0], 3, *shape[2:])
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6, atol=1e-6)


def test_ensemble_predict_matches_jax_composition():
    """Sigmoid mean over two fold models, then the 0.5 threshold, as ensemble_inference does it."""
    x = np.random.default_rng(2).standard_normal((1, 2, 20, 18, 12)).astype(np.float32)
    models_t = [_predict_torch, lambda w: 2.0 * _predict_torch(w)]
    models_j = [_predict_jax, lambda w: 2.0 * _predict_jax(w)]
    mask, probs = ftt.ensemble_predict(models_t, torch.from_numpy(x), (8, 8, 8), sw_batch_size=2, overlap=0.5)
    p_j = sum(
        jax.nn.sigmoid(sw_jax.sliding_window_inference(jnp.asarray(x), (8, 8, 8), m, sw_batch_size=2, overlap=0.5))
        for m in models_j
    ) / 2
    np.testing.assert_allclose(probs.numpy(), np.asarray(p_j), rtol=1e-6, atol=1e-6)
    assert mask.dtype == torch.uint8
    np.testing.assert_array_equal(mask.numpy(), (probs.numpy() > 0.5).astype(np.uint8))
