"""Shared checks of the baseline models' parity tests: a JAX module and its port with the same weights.

Not a test module: ``tests/test_torch_baselines.py`` and ``tests/test_torch_swinunetr.py`` import it.  A case is
``(make_jax(dtype_name), make_port(dtype_name), input shape, train, takes a dtype)``; the JAX module is initialised
from key 0 on an input made with numpy from a seed, and its variables go into the port module through
``load_flax_variables``, which checks that every Flax parameter is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.utils.helpers import materialize
from factorizer_tpu_torch.utils.weights import flax_state_dict

CPU = {"device": "cpu"}
JAX_DTYPES = {"float32": None, "bfloat16": jnp.bfloat16}
PORT_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def init_variables(model_j, x: np.ndarray, train: bool = False) -> dict:
    variables = jax.jit(lambda k, a: model_j.init(k, a, train=train) if train else model_j.init(k, a))(
        jax.random.key(0), jnp.asarray(x))
    return jax.tree.map(np.asarray, dict(variables))


def _apply(model_j, variables, x, train):
    kw = {"train": True} if train else {}
    return model_j.apply(variables, x, **kw)


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def bridged_case(case, dt: str = "float32", seed: int = 0):
    """The JAX module, its variables, the port module with them (in training mode where the case is), and the
    input made from ``seed``."""
    make_j, make_t, shape, train, _ = case
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    model_j = make_j(dt)
    variables = init_variables(model_j, x, train)
    model_t = materialize(make_t(dt), len(shape) - 2)
    ftt.load_flax_variables(model_t, variables)
    return model_j, variables, model_t.train(train), x, train


def check_float64(case) -> None:
    """float64 (``model.double()`` against JAX under x64): every output (the deep-supervision list in training mode)
    and every parameter gradient of ``sum(out * r)`` for a random ``r``, each to 1e-10 of its largest entry."""
    model_j, variables, model_t, x, train = bridged_case(case)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        xj = jnp.asarray(x, jnp.float64)
        outs = _flat(jax.jit(lambda p: _apply(model_j, {"params": p}, xj, train))(params))
        rng = np.random.default_rng(1)
        rs = [rng.standard_normal(np.shape(o)) for o in outs]

        def loss(p):
            return sum(jnp.sum(o * r) for o, r in zip(_flat(_apply(model_j, {"params": p}, xj, train)), rs))

        grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params))
        outs = [np.asarray(o) for o in outs]
    model_t.double()
    out_t = model_t(torch.from_numpy(x).double())
    got = _flat(out_t)
    assert len(got) == len(outs) and isinstance(out_t, list) == (len(outs) > 1)
    for o, want in zip(got, outs):
        assert o.dtype == torch.float64 and tuple(o.shape) == want.shape
        np.testing.assert_allclose(o.detach().numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())
    sum((o * torch.from_numpy(r)).sum() for o, r in zip(got, rs)).backward()
    expected = {k: v.numpy() for k, v in flax_state_dict(model_t, {"params": grads}).items()}
    named = dict(model_t.named_parameters())
    assert expected.keys() == named.keys()
    largest = max(np.abs(v).max() for v in expected.values())
    for key, want in expected.items():
        # A bias that a norm removes again has a gradient of rounding noise (~1e-14) where the function's is 0: such
        # a leaf is held to a thousandth of the model's largest gradient instead of its own.
        scale = max(np.abs(want).max(), 1e-3 * largest)
        np.testing.assert_allclose(named[key].grad.numpy(), want, rtol=0, atol=1e-10 * scale, err_msg=key)


def check_float32(case) -> None:
    """float32 outputs against the JAX module's, to 1e-4 of the largest."""
    model_j, variables, model_t, x, train = bridged_case(case, seed=2)
    want = _flat(jax.jit(lambda v, a: _apply(model_j, v, a, train))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _flat(model_t(torch.from_numpy(x)))
    for o, w in zip(got, want):
        w = np.asarray(w)
        assert o.dtype == torch.float32 and tuple(o.shape) == w.shape
        np.testing.assert_allclose(o.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


# The deep-supervision heads of DynUNet read the coarser decoder levels through a bfloat16 head: on the CPU each
# framework's bfloat16 heads lie 1.4e-2 to 2.0e-2 (of the largest output) from its float32 heads, in roundings of
# their own, and 1.9e-2 to 2.0e-2 from each other, so the band there is twice the main output's.
DEEP_HEAD_BF16 = 4e-2


def check_bfloat16(case) -> None:
    """``dtype=bfloat16`` (float32 parameters, bfloat16 compute, float32 norm statistics) against the JAX module with
    ``dtype=jnp.bfloat16``: the same output dtype, values within 2e-2 of the largest output (``DEEP_HEAD_BF16`` for
    the deep-supervision heads)."""
    model_j, variables, model_t, x, train = bridged_case(case, "bfloat16", seed=3)
    want = _flat(jax.jit(lambda v, a: _apply(model_j, v, a, train))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _flat(model_t(torch.from_numpy(x)))
    for i, (o, w) in enumerate(zip(got, want)):
        assert str(o.dtype).split(".")[1] == str(w.dtype) and tuple(o.shape) == w.shape
        w = np.asarray(w, np.float32)
        assert np.abs(o.float().numpy() - w).max() <= (2e-2 if i == 0 else DEEP_HEAD_BF16) * np.abs(w).max()


def jax_param_count(model, shape) -> int:
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros(shape))
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))


def check_param_count(make_j, make_t, shape) -> None:
    """The port's parameter count, built on ``meta``, equals ``jax.eval_shape``'s."""
    model_t = materialize(make_t(), len(shape) - 2)
    assert sum(p.numel() for p in model_t.parameters()) == jax_param_count(make_j(), shape)
