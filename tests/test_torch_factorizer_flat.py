"""Port parity for the flat-NMF route of the Factorizer: 2-D models, rank above 1, ``use_windowed: False``, ISLES.

The JAX models run their flat Pallas kernel in interpret mode
(``factorize_options={"use_pallas": True}``), forward and under ``jax.grad``;
the port runs on the CPU, where its wrappers take the kernels' plain versions.
Weights cross over through ``load_flax_variables``.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu.train import losses as jax_losses
from factorizer_tpu.utils.torch_import import convert_state_dict

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.factorization import nmf as port_nmf
from factorizer_tpu_torch.train import trainer as port_trainer

torch.set_num_threads(1)

BASE = dict(
    encoder_depth=(1, 1),
    encoder_width=(8, 16),
    strides=(1, 2),
    decoder_depth=(1,),
    mlp_ratio=4,
    act="relu",
    num_iters=5,
    init_method="uniform",
    solver="hals",
)
# name -> (model arguments, reshape arguments); every mixer of these models takes the flat route.
CASES = {
    "2d": (dict(in_channels=3, out_channels=1, spatial_size=(32, 32), rank=1), {"head_dim": 4, "patch_size": 4}),
    "3d_rank2": (dict(in_channels=2, out_channels=1, spatial_size=(16, 16, 16), rank=2),
                 {"head_dim": 4, "patch_size": 4, "shifts": [None, 1, 2, 3]}),
}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield ".".join((*prefix, k)), np.asarray(v)


_JAX_SIDE = {}


def _jax_side(case):
    """The JAX model on its flat Pallas kernel, and its variables (numpy leaves), built once per case."""
    if case not in _JAX_SIDE:
        cfg, sw = CASES[case]
        model = ftx.Factorizer(**BASE, **cfg, reshape=(ftx.SWMatricize, sw), factorize_options={"use_pallas": True})
        variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, cfg["in_channels"], *cfg["spatial_size"])))
        _JAX_SIDE[case] = model, jax.tree.map(np.array, flax.core.unfreeze(dict(variables)))
    return _JAX_SIDE[case]


def _port_model(case, variables, seed=1, **overrides):
    cfg, sw = CASES[case]
    model = ftt.Factorizer(**BASE, **cfg, reshape=(ftt.SWMatricize, sw), device="cpu",
                           generator=torch.Generator().manual_seed(seed), **overrides)
    return ftt.load_flax_variables(model, variables) if variables is not None else model


def _batch(case, seed, b):
    cfg, _ = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cfg["in_channels"], *cfg["spatial_size"])).astype(np.float32)
    y = (rng.random((b, cfg["out_channels"], *cfg["spatial_size"])) > 0.7).astype(np.float32)
    return x, y


@pytest.mark.parametrize("case,batch", [("2d", 2), ("3d_rank2", 1)])
def test_slice_logits_and_gradients_match_jax(case, batch, monkeypatch):
    """The reduced flat-route model against ``model.apply`` and ``jax.grad`` on the interpret-mode Pallas kernel:
    logits to 1e-4 of the largest logit, the DiceCE loss to rtol 1e-5, every gradient leaf to 1e-3 of its largest
    entry (f32; three blocks of five HALS iterations, summed in other orders; at rank 2 the Gauss-Seidel sweep
    subtracts nearly equal sums).  Every mixer of the port goes through ``nmf_reconstruct``."""
    model_j, variables = _jax_side(case)
    x, y = _batch(case, seed=3, b=batch)

    def loss_and_logits(params):
        v = {"params": params, "buffers": variables["buffers"]}
        logits = model_j.apply(v, jnp.asarray(x), train=True, rngs={"dropout": jax.random.key(0)})
        return jax_losses.dice_ce_loss(logits, jnp.asarray(y)), logits

    (loss_j, logits_j), grads_j = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))(variables["params"])
    expected = dict(_leaves(jax.tree.map(np.asarray, grads_j)))
    logits_j = np.asarray(logits_j)

    calls = []
    wrapper = port_nmf.nmf_kernel.nmf_reconstruct
    monkeypatch.setattr(port_nmf.nmf_kernel, "nmf_reconstruct", lambda *a: calls.append(a[0].shape) or wrapper(*a))
    model_t = _port_model(case, variables)
    assert all(b.fact.windowed is None for b in model_t.modules() if isinstance(b, ftt.FactorizerBlock))
    with torch.no_grad():
        logits_t = model_t(torch.from_numpy(x)).numpy()
    assert len(calls) == 3 and logits_t.shape == logits_j.shape
    np.testing.assert_allclose(logits_t, logits_j, rtol=0, atol=1e-4 * np.abs(logits_j).max())

    state = port_trainer.create_train_state(model_t, device="cpu", lr=0.0)
    state, metrics = port_trainer.make_train_step(model_t)(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    np.testing.assert_allclose(metrics["loss"].item(), float(loss_j), rtol=1e-5)
    grads = {k: p.grad for k, p in model_t.named_parameters()}
    assert all(g is not None for g in grads.values())
    as_state = {k: grads.get(k, torch.zeros_like(v)) for k, v in model_t.state_dict().items()}
    got = dict(_leaves(convert_state_dict(as_state)["params"]))
    assert got.keys() == expected.keys()
    for key, want in expected.items():
        np.testing.assert_allclose(got[key], want, rtol=0, atol=1e-3 * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_bridge_round_trip(case):
    """``convert_state_dict(port.state_dict())`` reproduces the Flax variables of a 2-D model and of rank-2 tables
    leaf for leaf, bit for bit, and loading them back restores the state dict."""
    _, variables = _jax_side(case)
    model_t = _port_model(case, variables)
    back = convert_state_dict(model_t.state_dict())
    for collection in ("params", "buffers"):
        want, got = dict(_leaves(variables[collection])), dict(_leaves(back[collection]))
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    rank = CASES[case][0]["rank"]
    tables = {k: v.shape for k, v in _leaves(back["buffers"])}
    assert tables and all(s[1] == rank for s in tables.values())
    other = ftt.load_flax_variables(_port_model(case, None, seed=2), back)
    for key, value in model_t.state_dict().items():
        assert torch.equal(other.state_dict()[key], value), key


def _mixer_pair(options_j, options_t):
    """A JAX FactMixer and the port's, 3-D and K1-eligible (rank 1), with the same weights; and an input."""
    rank = 1
    c, sp = 8, (8, 8, 8)
    sw = {"head_dim": 4, "patch_size": 4, "shifts": [None, 1, 2, 3]}
    opts = dict(num_iters=5, init_method="uniform", solver="hals")
    m_j = ftx.FactMixer(c, c, sp, reshape=(ftx.SWMatricize, sw), rank=rank, factorize_options=options_j, **opts)
    x = np.random.default_rng(3).standard_normal((2, *sp, c)).astype(np.float32)
    v = jax.tree.map(np.asarray, dict(m_j.init(jax.random.key(0), jnp.asarray(x))))
    m_t = ftt.FactMixer(c, c, sp, reshape=(ftt.SWMatricize, sw), factorize_kwargs=dict(rank=rank, **opts),
                        factorize_options=options_t)
    p, init = v["params"], v["buffers"]["factorize_op"]["initializer"]
    m_t.load_state_dict({
        "in_proj.linear.weight": torch.tensor(p["in_proj"]["linear"]["kernel"].T),
        "out_proj.linear.weight": torch.tensor(p["out_proj"]["linear"]["kernel"].T),
        "out_proj.linear.bias": torch.tensor(p["out_proj"]["linear"]["bias"]),
        "factorize.init.u0": torch.tensor(init["u0"]),
        "factorize.init.v0": torch.tensor(init["v0"]),
    })
    return m_j, v, m_t, x


def test_factmixer_opt_out_matches_jax_and_the_windowed_route():
    """``{"use_windowed": False}`` takes a K1-eligible mixer to fold -> NMF -> unfold.  Against the JAX mixer under
    ``{"use_pallas": True, "use_windowed": False}`` (its flat Pallas kernel, interpreted): 1e-5.  Against the
    port's own windowed route, forward and dx: equal within f32 rounding (1e-6 of the largest entry)."""
    m_j, v, m_flat, x = _mixer_pair({"use_pallas": True, "use_windowed": False}, {"use_windowed": False})
    assert m_flat.windowed is None and m_flat.factorize.supports()
    y_j = np.asarray(m_j.apply(v, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_flat = m_flat(xt)
    np.testing.assert_allclose(y_flat.detach().numpy(), y_j, rtol=1e-5, atol=1e-5)

    m_win = ftt.FactMixer(8, 8, (8, 8, 8), reshape=(ftt.SWMatricize, {"head_dim": 4, "patch_size": 4, "shifts": [None, 1, 2, 3]}),
                          factorize_kwargs=dict(rank=1, num_iters=5, init_method="uniform", solver="hals"))
    m_win.load_state_dict(m_flat.state_dict())
    assert m_win.windowed == (4, 4, (None, (1, 1, 1), (2, 2, 2), (3, 3, 3)))
    xw = torch.from_numpy(x).requires_grad_(True)
    y_win = m_win(xw)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(y_j.shape).astype(np.float32))
    y_flat.backward(g)
    y_win.backward(g)
    for a, b in ((y_flat.detach(), y_win.detach()), (xt.grad, xw.grad)):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()


def test_factorize_options_takes_use_windowed_alone():
    """The JAX package's kernel keys are taken as it takes them: ``use_pallas: False`` (pure-XLA mode) puts a K1
    mixer on the flat route with its factorizer off K4, equal to the ``use_windowed: False`` mixer's K4 route within
    f32 rounding; ``use_pallas: True`` / None and ``explain: True`` keep K1, ``explain`` bit for bit;
    ``use_windowed: True`` and None keep the default; ``split_shifts`` is taken by a flat-route mixer, whose split
    route equals its concat route bit for bit.  (``spatial_mesh`` and ``spatial_axis`` are taken:
    ``tests/test_torch_windowed_sharded.py``.)"""
    sw = (ftt.SWMatricize, {"head_dim": 4, "patch_size": 4})
    fk = dict(rank=1, num_iters=3, init_method="uniform", solver="hals")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 8, 8, 8, 8)).astype(np.float32))
    mixers = {key: ftt.FactMixer(8, 8, (8, 8, 8), reshape=sw, factorize_kwargs=fk, factorize_options=options)
              for key, options in {"default": None, "pure": {"use_pallas": False}, "k4": {"use_windowed": False},
                                   "explain": {"explain": True}, "pallas": {"use_pallas": True},
                                   "auto": {"use_pallas": None}}.items()}
    for m in mixers.values():
        m.load_state_dict(mixers["default"].state_dict())
    pure, k4 = mixers["pure"], mixers["k4"]
    assert pure.windowed is None and pure.factorize.use_pallas is False and not pure.factorize.supports()
    assert pure.fallback_reason == "factorize_options['use_pallas'] is False (pure-XLA mode)"
    assert k4.windowed is None and k4.factorize.supports()
    assert all(mixers[k].windowed == mixers["default"].windowed is not None for k in ("explain", "pallas", "auto"))
    with torch.no_grad():
        y = {k: m(x) for k, m in mixers.items()}
    assert (y["pure"] - y["k4"]).abs().max() <= 1e-6 * y["k4"].abs().max()
    assert torch.equal(y["explain"], y["default"]) and torch.equal(y["pallas"], y["default"])
    concat = ftt.FactMixer(8, 8, (8, 8, 8), reshape=sw, factorize_kwargs=fk, factorize_options={"use_windowed": False})
    split = ftt.FactMixer(8, 8, (8, 8, 8), reshape=sw, factorize_kwargs=fk,
                          factorize_options={"use_windowed": False, "split_shifts": True})
    split.load_state_dict(concat.state_dict())
    assert split.splits_shifts and not concat.splits_shifts and split.windowed is None
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 8, 8, 8, 8)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(split(x), concat(x))
    for options in (None, {}, {"use_windowed": True}, {"use_windowed": None}):
        assert ftt.FactMixer(8, 8, (8, 8, 8), reshape=sw, factorize_kwargs={"rank": 1}, factorize_options=options).windowed
    assert ftt.FactMixer(8, 8, (8, 8), reshape=sw, factorize_kwargs={"rank": 1}).windowed is None  # 2-D: the flat route


WIDE = dict(encoder_depth=(1, 1, 1, 1, 1), encoder_width=(32, 64, 128, 256, 512), strides=(1, 2, 2, 2, 2), decoder_depth=(1, 1, 1, 1))
NARROW = dict(encoder_depth=(1, 1), encoder_width=(8, 16), strides=(1, 2), decoder_depth=(1,))


def _isles_pair(bundle, reduced):
    """The JAX model of an ISLES bundle's ``network_def`` and the port's model with the same settings, at full
    width or reduced (two stages, widths 8/16, roi 16^3, head_dim 4)."""
    size = dict(NARROW if reduced else WIDE)
    if bundle == "factorizer_isles22":
        common = dict(in_channels=2, out_channels=1, spatial_size=(16,) * 3 if reduced else (64,) * 3, mlp_ratio=4,
                      act="relu", rank=1, num_iters=5, init_method="uniform", solver="hals", **size)
        sw = {"head_dim": 4 if reduced else 8, "patch_size": 4, "shifts": [None, 1, 2, 3]}
        return (ftx.Factorizer(**common, reshape=(ftx.SWMatricize, sw)),
                lambda: ftt.Factorizer(**common, reshape=(ftt.SWMatricize, sw), device="cpu"))
    common = dict(in_channels=2, out_channels=1, spatial_dims=3, act="relu", groups=-1, ratio=1, kernel_size=(3, 3, 3),
                  num_iters=1, mlp_ratio=4, **size)
    return (ftx.Deconver(**common, norm=ftx.InstanceNorm),
            lambda: ftt.Deconver(**common, norm=ftt.InstanceNorm, device="cpu"))


ISLES_FACTORIES = {"factorizer_isles22": ftt.factorizer_isles22_network, "deconver_isles22": ftt.deconver_isles22_network}


@pytest.mark.parametrize("bundle", list(ISLES_FACTORIES))
def test_isles_factories_match_the_jax_bundles(bundle):
    """The ISLES factories at full width: parameter and buffer names and shapes equal those of the JAX bundle's
    ``network_def`` (zoo/<bundle>/configs/train.yaml), through ``convert_state_dict``; 2 channels in, 1 out."""
    factory = ISLES_FACTORIES[bundle]
    port = factory(device="meta")
    model_j, _ = _isles_pair(bundle, reduced=False)
    shapes = jax.eval_shape(model_j.init, jax.random.key(0), jax.ShapeDtypeStruct((1, 2, 64, 64, 64), jnp.float32))
    expected = {k: tuple(v.shape) for k, v in _leaves(jax.tree.map(lambda s: np.empty(s.shape, np.int8), dict(shapes)))}
    state = {k: np.empty(tuple(v.shape), np.int8) for k, v in port.state_dict().items()}
    converted = {k: v.shape for k, v in _leaves(convert_state_dict(state))}
    assert converted == expected
    assert (port.stem.weight.shape[1], port.head.weight.shape[0]) == (2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        factory()


@pytest.mark.parametrize("bundle", list(ISLES_FACTORIES))
def test_reduced_isles_networks_match_jax(bundle):
    """A reduced copy of each ISLES network (two stages, widths 8/16, roi 16^3, the bundle's other settings):
    logits against ``model.apply`` to 1e-4 of the largest logit."""
    model_j, port_model = _isles_pair(bundle, reduced=True)
    variables = jax.jit(model_j.init)(jax.random.key(0), jnp.zeros((1, 2, 16, 16, 16)))
    variables = jax.tree.map(np.array, flax.core.unfreeze(dict(variables)))
    model_t = ftt.load_flax_variables(port_model(), variables).eval()
    x = np.random.default_rng(8).standard_normal((2, 2, 16, 16, 16)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: model_j.apply(v, a))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model_t(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, 16, 16, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
