"""Port parity for the train step: gradients, a 5-step AdamW trajectory, accumulation and bf16.

The reduced Factorizer of ``tests/test_torch_factorizer.py`` with the JAX
model's weights carried across by ``load_flax_variables``; everything runs on
the CPU (``device="cpu"``), where the port's wrappers take the kernels' plain
versions and the JAX model its SWMatricize -> NMF and unfused-MLP paths.
"""

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
from factorizer_tpu_torch.train import trainer as port_trainer

torch.set_num_threads(1)

SP = (16, 16, 16)
CONFIG = dict(
    in_channels=4,
    out_channels=3,
    spatial_size=SP,
    encoder_depth=(1, 1, 1),
    encoder_width=(8, 16, 16),
    strides=(1, 2, 2),
    decoder_depth=(1, 1),
    mlp_ratio=4,
    act="relu",
    rank=1,
    num_iters=5,
    init_method="uniform",
    solver="hals",
)
SW = {"head_dim": 4, "patch_size": 4, "shifts": [None, 1, 2, 3]}
OPT = dict(lr=1e-3, weight_decay=1e-2, warmup_steps=2, total_steps=6)
STEPS = 5


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield ".".join((*prefix, k)), np.asarray(v)


def _batches(n, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal((b, 4, *SP)).astype(np.float32), (rng.random((b, 3, *SP)) > 0.7).astype(np.float32))
        for _ in range(n)
    ]


def _torch_batch(x, y):
    return {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model and its variables (numpy leaves)."""
    model = ftx.Factorizer(**CONFIG, reshape=(ftx.SWMatricize, SW))
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 4, *SP)))
    return model, jax.tree.map(np.asarray, dict(variables))


def _port_state(variables, dtype=None, **settings):
    def factory(device):
        model = ftt.Factorizer(**CONFIG, reshape=(ftt.SWMatricize, SW), dtype=dtype, device=device,
                               generator=torch.Generator().manual_seed(1))
        ftt.load_flax_variables(model, variables)
        return model

    return port_trainer.create_train_state(factory, device="cpu", **settings)


def test_create_train_state_defaults_to_the_card():
    """Without a device argument the state is built on the card, and here, with none, it raises."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_trainer.create_train_state(lambda device: torch.nn.Linear(2, 2, device=device), lr=1e-3)
    state = port_trainer.create_train_state(torch.nn.Linear(2, 2), device="cpu", lr=1e-3)
    assert state.step == 0 and state.schedule is None and next(state.model.parameters()).device.type == "cpu"


def test_one_step_loss_and_gradients_match_jax(jax_side):
    """One step's loss (rtol 1e-5) and every parameter gradient against jax.value_and_grad, leaf for leaf.

    f32; each leaf to rtol 1e-3 with atol 1e-3 of its largest entry: the
    gradients pass back through 5 blocks of 5 HALS iterations, whose sums the
    two frameworks take in other orders.  The batch's seed is one for which
    no ReLU input lies within f32 rounding of zero: such an input (seed 0 has
    one, 6e-8, in the first decoder block) takes either side of the ReLU by
    the order of a sum, and the gradient of everything below it moves by
    percents in either framework, while in f64 the two agree to 1e-14.
    """
    model, variables = jax_side
    x, y = _batches(1, seed=5)[0]

    def compute_loss(params):
        v = {"params": params, "buffers": variables["buffers"]}
        logits = model.apply(v, jnp.asarray(x), train=True, rngs={"dropout": jax.random.key(0)})
        return jax_losses.dice_ce_loss(logits, jnp.asarray(y))

    loss_j, grads_j = jax.jit(jax.value_and_grad(compute_loss))(variables["params"])
    expected = dict(_leaves(jax.tree.map(np.asarray, grads_j)))

    state = _port_state(variables, lr=0.0)
    state, metrics = port_trainer.make_train_step(state.model)(state, _torch_batch(x, y))
    np.testing.assert_allclose(metrics["loss"].item(), float(loss_j), rtol=1e-5)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    assert all(g is not None for g in grads.values())
    as_state = {k: grads.get(k, torch.zeros_like(v)) for k, v in state.model.state_dict().items()}
    got = dict(_leaves(convert_state_dict(as_state)["params"]))
    assert got.keys() == expected.keys()
    worst = max(expected, key=lambda k: np.abs(got[k] - expected[k]).max() / max(np.abs(expected[k]).max(), 1e-12))
    print("worst leaf:", worst, np.abs(got[worst] - expected[worst]).max() / np.abs(expected[worst]).max())
    for key, want in expected.items():
        np.testing.assert_allclose(got[key], want, rtol=1e-3, atol=1e-3 * np.abs(want).max(), err_msg=key)
    norm_j = float(jnp.sqrt(sum(jnp.sum(g**2) for g in jax.tree.leaves(grads_j))))
    np.testing.assert_allclose(metrics["grad_norm"].item(), norm_j, rtol=1e-4)


def test_one_step_gradients_match_jax_f64(jax_side):
    """The semantic check: the model in f64 (``model.double()``) against JAX under x64, every leaf to 1e-10.

    On seed 0's batch, where f32 runs of either framework disagree by percents
    below one ReLU input of 6e-8 (see above).
    """
    model, variables = jax_side
    x, y = (a.astype(np.float64) for a in _batches(1)[0])
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        buffers = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["buffers"])

        def compute_loss(p):
            logits = model.apply({"params": p, "buffers": buffers}, jnp.asarray(x), train=True,
                                 rngs={"dropout": jax.random.key(0)})
            return jax_losses.dice_ce_loss(logits, jnp.asarray(y))

        loss_j, grads_j = jax.jit(jax.value_and_grad(compute_loss))(params)
        expected = dict(_leaves(jax.tree.map(np.asarray, grads_j)))
    state = _port_state(variables, lr=0.0)
    state.model.double()
    state, metrics = port_trainer.make_train_step(state.model)(state, _torch_batch(x, y))
    assert metrics["loss"].dtype == torch.float64
    np.testing.assert_allclose(metrics["loss"].item(), float(loss_j), rtol=1e-12)
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    as_state = {k: grads.get(k, torch.zeros_like(v)) for k, v in state.model.state_dict().items()}
    got = dict(_leaves(convert_state_dict(as_state)["params"]))
    for key, want in expected.items():
        assert got[key].dtype == np.float64
        np.testing.assert_allclose(got[key], want, rtol=1e-10, atol=1e-10 * np.abs(want).max(), err_msg=key)


def test_five_step_trajectory_matches_jax(jax_side):
    """Five AdamW + warm-up-cosine steps from the same weights on the same batches: loss per step to rtol 1e-4.

    Against the JAX ``make_train_step`` with the per-leaf optimiser
    (``flat_optimizer=False``).  The first update runs at lr 0 in both, so
    steps 1 and 2 see the same weights; by step 5 three updates of up to 1e-3
    have moved every parameter.
    """
    model, variables = jax_side
    batches = _batches(STEPS, seed=1)
    tx = jax_schedules.make_adamw(**OPT)
    params = jax.tree.map(jnp.array, variables["params"])
    state_j = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, buffers=jax.tree.map(jnp.array, variables["buffers"]),
        opt_state=jax_trainer.init_opt_state(tx, params, False), tx=tx, flat_opt=False,
    )
    step_j = jax_trainer.make_train_step(model, donate=False)
    state_t = _port_state(variables, **OPT)
    step_t = port_trainer.make_train_step(state_t.model)
    losses_j, losses_t = [], []
    for x, y in batches:
        state_j, m_j = step_j(state_j, {"image": jnp.asarray(x), "label": jnp.asarray(y)}, jax.random.key(0))
        state_t, m_t = step_t(state_t, _torch_batch(x, y))
        losses_j.append(float(m_j["loss"]))
        losses_t.append(m_t["loss"].item())
    assert state_t.step == STEPS == int(state_j.step)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    # the parameters after the five steps, through the bridge: 1e-4 of each leaf's largest entry
    got = dict(_leaves(convert_state_dict(state_t.model.state_dict())["params"]))
    for key, want in _leaves(jax.tree.map(np.asarray, state_j.params)):
        np.testing.assert_allclose(got[key], want, rtol=1e-3, atol=1e-4 * np.abs(want).max(), err_msg=key)


def test_accumulation_equals_full_batch_step(jax_side):
    """accum_steps=2 on a batch of 4 gives the full-batch step: loss, gradient norm and parameters to 1e-5."""
    _, variables = jax_side
    x, y = _batches(1, b=4, seed=2)[0]
    results = []
    for accum in (1, 2):
        state = _port_state(variables, lr=1e-3, weight_decay=1e-2)
        state, m = port_trainer.make_train_step(state.model, accum_steps=accum)(state, _torch_batch(x, y))
        results.append((m, [p.detach().clone() for p in state.model.parameters()]))
    (m1, p1), (m2, p2) = results
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(), rtol=1e-5)
    np.testing.assert_allclose(m2["grad_norm"].item(), m1["grad_norm"].item(), rtol=1e-4)
    for a, b in zip(p2, p1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        port_trainer.make_train_step(state.model, accum_steps=3)(state, _torch_batch(x, y))


def test_bf16_step_loss_matches_jax(jax_side):
    """The bf16 model (f32 parameters, bf16 activations, f32 loss): the step's loss within 5e-2 of JAX's."""
    _, variables = jax_side
    x, y = _batches(1, seed=3)[0]
    model_j = ftx.Factorizer(**CONFIG, reshape=(ftx.SWMatricize, SW), dtype=jnp.bfloat16)
    logits = jax.jit(lambda v, t: model_j.apply(v, t, train=True, rngs={"dropout": jax.random.key(0)}))(variables, jnp.asarray(x))
    loss_j = jax_losses.dice_ce_loss(logits, jnp.asarray(y))
    state = _port_state(variables, dtype=torch.bfloat16, lr=1e-3)
    state, m = port_trainer.make_train_step(state.model)(state, _torch_batch(x, y))
    assert m["loss"].dtype == torch.float32 and loss_j.dtype == jnp.float32
    np.testing.assert_allclose(m["loss"].item(), float(loss_j), rtol=5e-2)
    assert all(p.grad is not None and p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in state.model.parameters())


def test_eval_step_runs_without_a_graph(jax_side):
    """make_eval_step: logits in eval mode under no_grad, equal to the JAX forward to 1e-4."""
    model, variables = jax_side
    x, _ = _batches(1, seed=4)[0]
    state = _port_state(variables, lr=1e-3)
    logits = port_trainer.make_eval_step(state.model)(torch.from_numpy(x))
    assert not logits.requires_grad and not state.model.training
    want = np.asarray(jax_trainer.make_eval_step(model)(variables, jnp.asarray(x)))
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4, atol=1e-4)
