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


@pytest.mark.parametrize("shape,sw_batch", [((1, 2, 20, 18, 12), 3), ((2, 2, 6, 18, 12), 4)])
def test_stitch_on_host_equals_device_sums(shape, sw_batch):
    """Blending into host sums gives the device sums bit for bit (the same float32 operations in the same order);
    ``predictor_args`` reach the predictor on both paths."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(shape).astype(np.float32))
    scale = torch.tensor(1.5)

    def predict(windows, s):
        return _predict_torch(windows) * s

    fused = sw_torch.sliding_window_inference(x, (8, 8, 8), predict, sw_batch_size=sw_batch, predictor_args=(scale,))
    host = sw_torch.sliding_window_inference(x, (8, 8, 8), predict, sw_batch_size=sw_batch, predictor_args=(scale,),
                                             stitch_on_host=True)
    assert host.device == x.device and host.dtype == torch.float32
    assert torch.equal(host, fused)
    torch.testing.assert_close(fused, 1.5 * sw_torch.sliding_window_inference(x, (8, 8, 8), _predict_torch,
                                                                              sw_batch_size=sw_batch), rtol=1e-6, atol=1e-6)


def _out_of_memory_above(n):
    """A predictor that raises the card's out-of-memory error for groups of more than ``n`` windows, and records
    the group sizes it ran."""
    calls = []

    def predict(windows):
        calls.append(windows.shape[0])
        if windows.shape[0] > n:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return _predict_torch(windows)

    return predict, calls


def test_adapt_ladder_steps_down_on_out_of_memory():
    """Fused -> host-stitched -> sw_batch halved: 4 windows fail twice (two warnings), then 2 run; the rung holds for
    the next call (no warning), and the result is that rung's direct call."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 2, 20, 18, 12)).astype(np.float32))
    inferer = sw_torch.SlidingWindowInfererAdapt((8, 8, 8), sw_batch_size=4)
    predict, calls = _out_of_memory_above(2)
    with pytest.warns(UserWarning) as record:
        out = inferer(x, predict)
    assert [str(w.message) for w in record] == [
        "sliding-window inference ran out of device memory; retrying with host-stitched blending",
        "sliding-window inference ran out of device memory; retrying with sw_batch_size=2",
    ]
    assert calls[:2] == [4, 4] and set(calls[2:]) == {2}
    assert inferer._stitch_on_host and inferer._sw_batch == 2
    want = sw_torch.sliding_window_inference(x, (8, 8, 8), _predict_torch, sw_batch_size=2, stitch_on_host=True)
    assert torch.equal(out, want)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(inferer(x, predict), want)


def test_adapt_ladder_matches_jax_rungs():
    """The JAX inferer, failing on the same group sizes, ends on the same rung with the same blended output (1e-6)."""
    x = np.random.default_rng(5).standard_normal((1, 2, 20, 18, 12)).astype(np.float32)

    def predict_jax(windows):
        if windows.shape[0] > 1:
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
        return _predict_jax(windows)

    inferer_j = sw_jax.SlidingWindowInfererAdapt((8, 8, 8), sw_batch_size=4)
    inferer_t = sw_torch.SlidingWindowInfererAdapt((8, 8, 8), sw_batch_size=4)
    with pytest.warns(UserWarning):
        y_j = inferer_j(jnp.asarray(x), predict_jax)
    with pytest.warns(UserWarning):
        y_t = inferer_t(torch.from_numpy(x), _out_of_memory_above(1)[0])
    assert (inferer_t._stitch_on_host, inferer_t._sw_batch) == (inferer_j._stitch_on_host, inferer_j._sw_batch) == (True, 1)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6, atol=1e-6)


def test_adapt_ladder_reraises_other_errors_and_the_last_rung():
    """Only the out-of-memory error moves the rung: any other error propagates at once, and out of memory at
    sw_batch_size 1 on host sums propagates too."""
    x = torch.zeros(1, 2, 8, 8, 8)
    inferer = sw_torch.SlidingWindowInfererAdapt((8, 8, 8), sw_batch_size=2)

    def broken(windows):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        inferer(x, broken)
    assert not inferer._stitch_on_host and inferer._sw_batch == 2
    always, calls = _out_of_memory_above(0)
    with pytest.warns(UserWarning), pytest.raises(torch.cuda.OutOfMemoryError):
        inferer(x, always)
    assert calls == [2, 2, 1] and inferer._stitch_on_host and inferer._sw_batch == 1
