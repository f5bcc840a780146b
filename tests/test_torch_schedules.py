"""Port parity: the warm-up-cosine schedule, gradient clipping and AdamW against optax."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from factorizer_tpu.train import schedules as js

from factorizer_tpu_torch.train import schedules as ts

torch.set_num_threads(1)


@pytest.mark.parametrize("warmup,total", [(5, 50), (1, 10), (0, 8), (10, 5)])
def test_schedule_matches_optax(warmup, total):
    """The schedule at steps 0, 1, w-1, w, w+1, total, total+5 (and between): 1e-7 of the peak lr."""
    lr = 1e-4
    want = js.warmup_cosine_schedule(lr, warmup, total)
    got = ts.warmup_cosine_schedule(lr, warmup, total)
    steps = sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1, (warmup + total) // 2, total, total + 5})
    for step in steps:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=0, atol=1e-7 * lr, err_msg=f"step {step}")
    assert got(0) == 0.0  # the first update runs at lr 0


def test_schedule_end_value():
    """A non-zero end lr is reached at total_steps and held: 1e-7 of the peak lr."""
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 3, 20, end_value=1e-5)
    got = ts.warmup_cosine_schedule(1e-3, 3, 20, end_lr=1e-5)
    for step in (0, 2, 3, 11, 20, 30):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=0, atol=1e-10)


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (7,), (2, 2, 2))]


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    """Above the norm the gradients are scaled by max_norm / norm, below they stay bit for bit; rtol 1e-6."""
    grads = _grads()
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = ts.clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm([jnp.asarray(g) for g in grads])), rtol=1e-6)
    for g, w, before in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        if max_norm > 10:
            np.testing.assert_array_equal(g.numpy(), before)


@pytest.mark.parametrize("scheduled", [True, False])
def test_adamw_trajectory_matches_optax(scheduled):
    """Five AdamW updates on fixed gradients, with and without the schedule: rtol 1e-5, atol 1e-6.

    The updates are ~1e-2 on parameters of order 1 and are rounded to f32 at
    other places in the two libraries.

    optax multiplies the weight decay by the learning rate, as torch does, so
    both take the same ``weight_decay``; the schedule is read at the count of
    updates already made, so the first update runs at lr 0.
    """
    kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=2, total_steps=8) if scheduled else dict(lr=1e-2, weight_decay=0.1)
    params_np = _grads(seed=1)
    tx = js.make_adamw(**kw)
    jparams = [jnp.asarray(p) for p in params_np]
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params_np]
    opt, schedule = ts.make_adamw(tparams, **kw)
    assert (schedule is not None) == scheduled
    for step in range(5):
        grads = _grads(seed=10 + step)
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        if schedule is not None:
            for group in opt.param_groups:
                group["lr"] = schedule(step)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, w in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=f"step {step}")
