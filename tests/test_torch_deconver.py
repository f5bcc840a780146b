"""Port parity for the Deconver: logits, every gradient leaf, the weight bridge and one train step.

A reduced model (three stages, widths 8/16/32) in 3-D (kernel 3x3x3) and 2-D
(kernel 7x7), with ``InstanceNorm`` (the bundles' norm: stock tails) and
``LayerNorm`` (the block tails take K2, here its plain version), the JAX
model's weights carried across by ``load_flax_variables``.  Everything runs on
the CPU: the port's depthwise convolutions take K3's plain version, the JAX
model its ``lax`` path.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu.train import losses as jax_losses
from factorizer_tpu.train import schedules as jax_schedules
from factorizer_tpu.train import trainer as jax_trainer
from factorizer_tpu.utils.torch_import import convert_state_dict

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.layers import basic as port_basic
from factorizer_tpu_torch.ops.kernels import prenorm_mlp as k2
from factorizer_tpu_torch.train import trainer as port_trainer

torch.set_num_threads(1)

BASE = dict(
    encoder_depth=(1, 1, 1),
    encoder_width=(8, 16, 32),
    strides=(1, 2, 2),
    decoder_depth=(1, 1),
    act="relu",
    groups=-1,
    ratio=1,
    num_iters=1,
    num_grad_iters=None,
    mlp_ratio=4,
)
DIMS = {
    "3d": dict(in_channels=4, out_channels=3, spatial_dims=3, kernel_size=(3, 3, 3), size=(16, 16, 16)),
    "2d": dict(in_channels=3, out_channels=1, spatial_dims=2, kernel_size=(7, 7), size=(32, 32)),
}
NORMS = {"instance": (ftx.InstanceNorm, ftt.InstanceNorm), "layer": (ftx.LayerNorm, ftt.LayerNorm)}
CASES = [(d, n) for d in DIMS for n in NORMS]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield ".".join((*prefix, k)), np.asarray(v)


def _config(dims):
    cfg = dict(DIMS[dims])
    size = cfg.pop("size")
    return {**BASE, **cfg}, size


def _batch(dims, seed=0, b=2):
    cfg, size = _config(dims)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cfg["in_channels"], *size)).astype(np.float32)
    y = (rng.random((b, cfg["out_channels"], *size)) > 0.7).astype(np.float32)
    return x, y


_JAX_SIDE = {}


def _jax_side(dims, norm, **overrides):
    """The JAX model and its variables (numpy leaves), built once per case."""
    key = (dims, norm, tuple(sorted(overrides.items())))
    if key not in _JAX_SIDE:
        cfg, size = _config(dims)
        model = ftx.Deconver(**{**cfg, **overrides}, norm=NORMS[norm][0])
        variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, cfg["in_channels"], *size)))
        _JAX_SIDE[key] = model, jax.tree.map(np.array, flax.core.unfreeze(dict(variables)))
    return _JAX_SIDE[key]


def _port_model(dims, norm, variables, dtype=None, device="cpu", **overrides):
    cfg, _ = _config(dims)
    model = ftt.Deconver(**{**cfg, **overrides}, norm=NORMS[norm][1], dtype=dtype, device=device,
                         generator=torch.Generator().manual_seed(1))
    return ftt.load_flax_variables(model, variables)


def _jax_loss_and_grads(model, variables, x, y, dtype=jnp.float32):
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables["params"])

    def compute_loss(p):
        logits = model.apply({"params": p}, jnp.asarray(x, dtype), train=True, rngs={"dropout": jax.random.key(0)})
        return jax_losses.dice_ce_loss(logits, jnp.asarray(y, dtype))

    loss, grads = jax.jit(jax.value_and_grad(compute_loss))(params)
    return float(loss), dict(_leaves(jax.tree.map(np.asarray, grads)))


def _port_grads_as_flax(model):
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    as_state = {k: grads.get(k, torch.zeros_like(v)) for k, v in model.state_dict().items()}
    return dict(_leaves(convert_state_dict(as_state)["params"]))


@pytest.mark.parametrize("dims,norm", CASES)
def test_logits_match_jax(dims, norm, monkeypatch):
    """Logits of the reduced model against ``model.apply``: 1e-4 of the largest logit (f32, 5 blocks of
    convolution quotients and 7 convolutions).  LayerNorm sends the block tail of K2's one width here (32, the
    bottleneck) through K2's wrapper and the others (8, 16) to the stock chain, InstanceNorm none."""
    model_j, variables = _jax_side(dims, norm)
    x, _ = _batch(dims)
    calls = []
    monkeypatch.setattr(port_basic, "prenorm_mlp", lambda *a: calls.append(1) or k2(*a))
    model_t = _port_model(dims, norm, variables).eval()
    with torch.no_grad():
        logits = model_t(torch.from_numpy(x))
    assert len(calls) == (1 if norm == "layer" else 0)
    want = np.asarray(jax.jit(lambda v, a: model_j.apply(v, a))(variables, jnp.asarray(x)))
    assert logits.shape == want.shape
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("dims,norm", CASES)
def test_bridge_round_trip(dims, norm):
    """``convert_state_dict(port.state_dict())`` reproduces the Flax variables leaf for leaf, bit for bit;
    InstanceNorm adds no entry on either side."""
    _, variables = _jax_side(dims, norm)
    model_t = _port_model(dims, norm, variables)
    back = convert_state_dict(model_t.state_dict())
    want = dict(_leaves(variables["params"]))
    got = dict(_leaves(back["params"]))
    assert got.keys() == want.keys() and "buffers" not in back
    assert any("dcm.deconv.h0" in k for k in got) and any("dcm.deconv.linear.linear.kernel" in k for k in got)
    assert any(".norm1." in k for k in got) == (norm == "layer")
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("dims,norm", CASES)
def test_one_step_loss_and_gradients_match_jax(dims, norm):
    """One train step of the reduced Deconver: the DiceCE loss (rtol 1e-5) and every parameter gradient
    against ``jax.value_and_grad``, each leaf to 1e-3 of its largest entry (f32; the gradients pass back
    through 5 blocks of convolution quotients and through norms over up to 4096 voxels, summed in other orders).
    The batch's seed is one with no ReLU input within f32 rounding of zero: such an input takes either side
    of the ReLU by the order of a sum and moves the gradients below it by 2e-3 (seed 5, 3-D InstanceNorm),
    while the f64 test below agrees to 1e-10."""
    model_j, variables = _jax_side(dims, norm)
    x, y = _batch(dims, seed=13)
    loss_j, expected = _jax_loss_and_grads(model_j, variables, x, y)
    state = port_trainer.create_train_state(lambda device: _port_model(dims, norm, variables, device=device),
                                            device="cpu", lr=0.0)
    state, metrics = port_trainer.make_train_step(state.model)(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    np.testing.assert_allclose(metrics["loss"].item(), loss_j, rtol=1e-5)
    got = _port_grads_as_flax(state.model)
    assert got.keys() == expected.keys()
    for key, want in expected.items():
        np.testing.assert_allclose(got[key], want, rtol=0, atol=1e-3 * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("dims", list(DIMS))
def test_gradients_match_jax_f64(dims):
    """The semantic check in f64 (``model.double()`` against JAX under x64), InstanceNorm: loss to 1e-12,
    every gradient leaf to 1e-10 of its largest entry."""
    model_j, variables = _jax_side(dims, "instance")
    x, y = (a.astype(np.float64) for a in _batch(dims, seed=6))
    with jax.enable_x64(True):
        loss_j, expected = _jax_loss_and_grads(model_j, variables, x, y, jnp.float64)
    model_t = _port_model(dims, "instance", variables).double()
    state = port_trainer.create_train_state(model_t, device="cpu", lr=0.0)
    state, metrics = port_trainer.make_train_step(model_t)(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    assert metrics["loss"].dtype == torch.float64
    np.testing.assert_allclose(metrics["loss"].item(), loss_j, rtol=1e-12)
    got = _port_grads_as_flax(model_t)
    for key, want in expected.items():
        assert got[key].dtype == np.float64
        np.testing.assert_allclose(got[key], want, rtol=0, atol=1e-10 * np.abs(want).max(), err_msg=key)


def test_default_grouping_and_two_iterations_match_jax():
    """The class defaults (groups 8, ratio 4, 2 iterations, LayerNorm) at widths 8/16/32: the stock grouped
    route, logits to 1e-4 of the largest logit."""
    overrides = dict(groups=8, ratio=4, num_iters=2)
    model_j, variables = _jax_side("3d", "layer", **overrides)
    x, _ = _batch("3d", seed=7)
    model_t = _port_model("3d", "layer", variables, **overrides).eval()
    with torch.no_grad():
        logits = model_t(torch.from_numpy(x))
    want = np.asarray(jax.jit(lambda v, a: model_j.apply(v, a))(variables, jnp.asarray(x)))
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_three_step_trajectory_matches_jax():
    """Three AdamW + warm-up-cosine steps of the 3-D InstanceNorm model from the same weights on the same
    batches, against the JAX ``make_train_step`` with the per-leaf optimiser: loss per step to rtol 1e-4."""
    opt = dict(lr=1e-3, weight_decay=1e-2, warmup_steps=1, total_steps=4)
    model_j, variables = _jax_side("3d", "instance")
    tx = jax_schedules.make_adamw(**opt)
    params = jax.tree.map(jnp.array, variables["params"])
    state_j = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=params, buffers={},
                                     opt_state=jax_trainer.init_opt_state(tx, params, False), tx=tx, flat_opt=False)
    step_j = jax_trainer.make_train_step(model_j, donate=False)
    state_t = port_trainer.create_train_state(_port_model("3d", "instance", variables), device="cpu", **opt)
    step_t = port_trainer.make_train_step(state_t.model)
    losses_j, losses_t = [], []
    for seed in (10, 11, 12):
        x, y = _batch("3d", seed=seed)
        state_j, m_j = step_j(state_j, {"image": jnp.asarray(x), "label": jnp.asarray(y)}, jax.random.key(0))
        state_t, m_t = step_t(state_t, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
        losses_j.append(float(m_j["loss"]))
        losses_t.append(m_t["loss"].item())
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]


@pytest.mark.parametrize("dims", list(DIMS))
def test_bf16_logits_match_jax(dims):
    """The bf16 model (f32 parameters and solve, bf16 activations, f32 head): logits within 5e-2 of the
    largest logit of JAX's bf16 model."""
    cfg, _ = _config(dims)
    _, variables = _jax_side(dims, "instance")
    x, _ = _batch(dims, seed=8)
    model_j = ftx.Deconver(**cfg, norm=ftx.InstanceNorm, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v, a: model_j.apply(v, a))(variables, jnp.asarray(x)))
    model_t = _port_model(dims, "instance", variables, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        logits = model_t(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=5e-2 * np.abs(want).max())


def test_sliding_window_serves_the_2d_model():
    """``ensemble_predict`` over a 2-D image larger than the roi: mask and probabilities of the image's shape,
    equal to the JAX sliding-window blend of the JAX model to 1e-4."""
    from factorizer_tpu.train.sliding_window import sliding_window_inference as jax_sliding_window

    model_j, variables = _jax_side("2d", "instance")
    x = np.random.default_rng(9).standard_normal((1, 3, 40, 48)).astype(np.float32)
    model_t = _port_model("2d", "instance", variables).eval()
    mask, probs = ftt.ensemble_predict([model_t], torch.from_numpy(x), (32, 32), sw_batch_size=2, overlap=0.5)
    assert tuple(mask.shape) == tuple(probs.shape) == (1, 1, 40, 48) and mask.dtype == torch.uint8
    logits_j = jax_sliding_window(jnp.asarray(x), (32, 32), lambda a: model_j.apply(variables, a), sw_batch_size=2, overlap=0.5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jax.nn.sigmoid(logits_j)), rtol=0, atol=1e-4)


def test_stem_matches_jax():
    """The patch-embedding stem (a stride-4 convolution and a LayerNorm) against the JAX module: 1e-5."""
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 3)).astype(np.float32)
    stem_j = ftx.models.deconver.Stem(3, 8, patch_size=(4, 4))
    variables = jax.tree.map(np.array, flax.core.unfreeze(stem_j.init(jax.random.key(0), jnp.asarray(x))))
    p = variables["params"]
    stem_t = ftt.Stem(3, 8, patch_size=(4, 4), device="cpu", generator=torch.Generator().manual_seed(0))
    stem_t.load_state_dict({
        "conv.weight": torch.from_numpy(np.ascontiguousarray(np.transpose(p["conv"]["conv"]["kernel"], (3, 2, 0, 1)))),
        "conv.bias": torch.from_numpy(p["conv"]["conv"]["bias"]),
        "norm.norm.weight": torch.from_numpy(p["norm"]["norm"]["scale"]),
        "norm.norm.bias": torch.from_numpy(p["norm"]["norm"]["bias"]),
    })
    want = np.asarray(stem_j.apply(variables, jnp.asarray(x)))
    got = stem_t(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 2, 3, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_constructor_refusals():
    """A kernel size of the wrong rank and widths that groups do not divide raise at construction."""
    with pytest.raises(ValueError, match="does not have 2 axes"):
        ftt.Deconver(3, 1, spatial_dims=2, device="cpu")
    with pytest.raises(ValueError, match="divisible by groups"):
        ftt.Deconver(4, 3, encoder_width=(12, 24, 48, 96, 192), groups=8, device="cpu")
