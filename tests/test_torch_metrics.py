"""The port's metrics against the JAX package's on the same seeded masks: Dice exactly, HD95 to 1e-6.

Dice runs on numpy masks (how the trainer fetches them) and on tensors; the
JAX side runs on numpy masks and on jax arrays.  MONAI's ``ignore_empty``
meaning is checked on its own cases: a channel empty in the ground truth is
NaN with ``ignore_empty=True`` and scores 1.0 (empty prediction) or 0.0
otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorizer_tpu.train import metrics as jax_metrics

from factorizer_tpu_torch.train import metrics as port_metrics

torch.set_num_threads(1)


def _masks(seed, shape=(3, 3, 12, 10, 8), density=(0.3, 0.4)):
    rng = np.random.default_rng(seed)
    pred = (rng.random(shape) < density[0]).astype(np.uint8)
    target = (rng.random(shape) < density[1]).astype(np.uint8)
    pred[0, 1] = 0  # an empty prediction channel
    target[1, 2] = 0  # an empty ground-truth channel, with a prediction
    target[2, 0] = pred[2, 0] = 0  # both empty
    return pred, target


@pytest.mark.parametrize("ignore_empty", [False, True])
@pytest.mark.parametrize("include_background", [True, False])
def test_dice_matches_jax_exactly(ignore_empty, include_background):
    """numpy masks: the (B, C) scores equal the JAX function's bit for bit, NaNs in the same places."""
    pred, target = _masks(0)
    kw = dict(include_background=include_background, ignore_empty=ignore_empty)
    got = port_metrics.dice_metric(pred, target, **kw)
    want = jax_metrics.dice_metric(pred, target, **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_dice_on_tensors_matches_numpy():
    """Tensors give the numpy result (float64 sums; exact for these counts), and the JAX device path agrees to f32."""
    pred, target = _masks(1)
    got = port_metrics.dice_metric(torch.from_numpy(pred), torch.from_numpy(target))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), port_metrics.dice_metric(pred, target))
    on_device = np.asarray(jax_metrics.dice_metric(jnp.asarray(pred), jnp.asarray(target)))
    np.testing.assert_allclose(got.numpy(), on_device, rtol=1e-6)
    nan = port_metrics.dice_metric(torch.from_numpy(pred), torch.from_numpy(target), ignore_empty=True)
    np.testing.assert_array_equal(nan.numpy(), port_metrics.dice_metric(pred, target, ignore_empty=True))


def test_dice_empty_channel_semantics():
    """MONAI's ignore_empty: NaN where the ground truth is empty; else 1.0 if the prediction is empty too, 0.0 if not."""
    pred, target = _masks(2)
    kept = port_metrics.dice_metric(pred, target)
    ignored = port_metrics.dice_metric(pred, target, ignore_empty=True)
    assert kept[2, 0] == 1.0 and kept[1, 2] == 0.0 and np.isnan(ignored[2, 0]) and np.isnan(ignored[1, 2])
    assert kept[0, 1] == 0.0  # an empty prediction against a ground truth that is not empty
    assert np.isfinite(ignored).sum() == ignored.size - 2


def test_mean_dice_matches_jax():
    """MeanDice over three updates (numpy and tensor masks): the mean and the per-channel means equal JAX's."""
    port, ref = port_metrics.MeanDice(), jax_metrics.MeanDice()
    for seed in range(3):
        pred, target = _masks(10 + seed)
        port.update(torch.from_numpy(pred) if seed == 1 else pred, target)
        ref.update(pred, target)
    assert port.compute() == ref.compute()
    np.testing.assert_array_equal(port.compute_per_channel(), ref.compute_per_channel())
    empty = port_metrics.MeanDice()
    assert np.isnan(empty.compute()) and empty.compute_per_channel().size == 0


@pytest.mark.parametrize("spacing", [None, (1.0, 1.5, 2.0), (0.5, 0.5, 3.0, 1.0)])
def test_hd95_matches_jax(spacing):
    """HD95 of two blobs, in voxels or in mm (the homogeneous 4th entry is dropped), to 1e-6 relative."""
    rng = np.random.default_rng(3)
    a = np.zeros((24, 20, 16), bool)
    b = np.zeros_like(a)
    a[4:14, 5:15, 3:11] = True
    b[7:19, 4:12, 6:14] = True
    a &= rng.random(a.shape) < 0.95
    got = port_metrics.hausdorff_distance_95(a, b, spacing=spacing)
    want = jax_metrics.hausdorff_distance_95(a, b, spacing=spacing)
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert port_metrics.hausdorff_distance_95(torch.from_numpy(a), torch.from_numpy(b), spacing=spacing) == got


def test_hd95_empty_and_wrong_spacing():
    """An empty mask gives NaN, as MONAI's; a spacing of the wrong rank raises."""
    a = np.zeros((6, 6, 6), bool)
    b = a.copy()
    b[2:4, 2:4, 2:4] = True
    assert np.isnan(port_metrics.hausdorff_distance_95(a, b))
    with pytest.raises(ValueError, match="spacing"):
        port_metrics.hausdorff_distance_95(b, b, spacing=(1.0, 1.0))


def test_mean_hausdorff_matches_jax():
    """MeanHausdorffDistance over a batch with spacing, background excluded, NaN channels skipped: JAX's to 1e-6."""
    pred, target = _masks(5, shape=(3, 3, 14, 12, 10), density=(0.05, 0.05))
    port = port_metrics.MeanHausdorffDistance(include_background=False)
    ref = jax_metrics.MeanHausdorffDistance(include_background=False)
    port.update(pred, target, spacing=(1.0, 1.2, 0.8))
    ref.update(pred, target, spacing=(1.0, 1.2, 0.8))
    assert len(port._scores) == 6
    np.testing.assert_allclose(port.compute(), ref.compute(), rtol=1e-6)
    assert np.isnan(port_metrics.MeanHausdorffDistance().compute())


@pytest.mark.parametrize("affine", [np.diag([1.2, 0.8, 2.5, 1.0]), np.array([[0, -1.5, 0, 10], [2.0, 0, 0, -5],
                                                                              [0, 0, 1.0, 3], [0, 0, 0, 1]])])
def test_voxel_spacing_from_meta_matches_jax(affine):
    """The spacing read from a meta dict's affine is JAX's; a meta without an affine gives None."""
    meta = {"affine": affine}
    assert port_metrics.voxel_spacing_from_meta(meta) == jax_metrics.voxel_spacing_from_meta(meta)
    assert port_metrics.voxel_spacing_from_meta({}) is None and port_metrics.voxel_spacing_from_meta(None) is None
