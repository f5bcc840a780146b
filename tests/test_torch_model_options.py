"""The models' remaining options against the JAX package: the generic UNet, the skeleton overrides, deep supervision,
``data_format``, dropout, the MLP's widths and bias, ``split_shifts`` and the K2 routing rule.

Small models (2-3 stages, widths 8-32, 16^3 volumes) on inputs made with numpy from a seed.  The JAX model is
initialised from key 0 and its variables go into the port's model through ``load_flax_variables``; in float64 the
outputs (the deep-supervision list where there are heads) and every parameter gradient of ``sum(out * r)`` agree to
1e-10 of the largest, and the bridge reads every Flax parameter and gives every state-dict entry.  Dropout cannot
draw JAX's masks: it is held at p = 0 in training mode, at p > 0 in evaluation mode, and by its keep rate and scale.
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu import config as jax_config
from factorizer_tpu.train import losses as jax_losses

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.config import ConfigParser
from factorizer_tpu_torch.layers import basic as port_basic
from factorizer_tpu_torch.layers.basic import prenorm_mlp_reason, prenorm_mlp_tail
from factorizer_tpu_torch.train import trainer as port_trainer
from factorizer_tpu_torch.utils.weights import _leaf_paths, flax_state_dict
from torch_bundle_cases import bundle_config

torch.set_num_threads(1)

F64_TOL = 1e-10
SP = (16, 16, 16)
SW = {"head_dim": 4, "patch_size": 4, "shifts": [None, 1, 2, 3]}


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


class _Read(dict):
    """Nested Flax variables that record each leaf read from them."""

    def __init__(self, tree, log: set, prefix=()):
        super().__init__({k: _Read(v, log, (*prefix, k)) if isinstance(v, Mapping) else v for k, v in tree.items()})
        self.log, self.prefix = log, prefix

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if not isinstance(value, Mapping):
            self.log.add((*self.prefix, key))
        return value


def assert_bridge_both_ways(model_t, variables) -> None:
    """Every state-dict entry has a Flax leaf (``flax_state_dict`` raises otherwise), and every Flax parameter is
    read."""
    log = set()
    state = flax_state_dict(model_t, _Read(variables, log))
    assert state.keys() == model_t.state_dict().keys()
    missing = {("params", *p) for p in _leaf_paths(variables["params"])} - log
    assert not missing, sorted(missing)[:5]


def init_variables(model_j, x: np.ndarray, **kw) -> dict:
    return jax.tree.map(np.asarray, dict(jax.jit(lambda k, a: model_j.init(k, a, **kw))(jax.random.key(0),
                                                                                         jnp.asarray(x))))


def check_float64(model_j, model_t, x: np.ndarray, train: bool = False, call=None) -> dict:
    """``model_t`` loaded with ``model_j``'s variables, in float64 and ``train`` mode: every output and every
    parameter gradient of ``sum(out * r)`` against JAX's to 1e-10 of its largest (a bias that a norm removes again:
    of a thousandth of the largest gradient); the bridge both ways.  Returns the variables."""
    call = call or (lambda m, v, a: m.apply(v, a, train=train))
    variables = init_variables(model_j, x)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        params, rest = v64["params"], {k: v for k, v in v64.items() if k != "params"}
        xj = jnp.asarray(x, jnp.float64)
        shapes = jax.eval_shape(lambda p: call(model_j, {"params": p, **rest}, xj), params)
        rng = np.random.default_rng(1)
        rs = [rng.standard_normal(o.shape) for o in _flat(shapes)]

        def loss(p):  # one compile for the outputs and the gradients
            out = call(model_j, {"params": p, **rest}, xj)
            return sum(jnp.sum(o * r) for o, r in zip(_flat(out), rs)), out

        (_, out_j), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        outs = [np.asarray(o) for o in _flat(out_j)]
        grads = jax.tree.map(np.asarray, grads)
    assert_bridge_both_ways(model_t, variables)
    ftt.load_flax_variables(model_t, variables)
    model_t.double().train(train)
    out_t = model_t(torch.from_numpy(x).double())
    got = _flat(out_t)
    assert len(got) == len(outs) and isinstance(out_t, list) == isinstance(out_j, list)
    for o, want in zip(got, outs):
        assert o.dtype == torch.float64 and tuple(o.shape) == want.shape
        np.testing.assert_allclose(o.detach().numpy(), want, rtol=0, atol=F64_TOL * np.abs(want).max())
    sum((o * torch.from_numpy(r)).sum() for o, r in zip(got, rs)).backward()
    expected = flax_state_dict(model_t, {"params": grads, **{k: v for k, v in variables.items() if k != "params"}})
    named = dict(model_t.named_parameters())
    largest = max(np.abs(expected[k].numpy()).max() for k in named)
    for key, p in named.items():
        want = expected[key].numpy()
        scale = max(np.abs(want).max(), 1e-3 * largest)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=F64_TOL * scale, err_msg=key)
    return variables


def _input(shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def factorizer(lib, stages: int = 2, **kw):
    """A Factorizer of ``lib`` (``ftx`` or ``ftt``) on 16^3: ``stages`` stages of widths 8, 16, 16."""
    depth = (1,) * stages
    args = dict(in_channels=4, out_channels=3, spatial_size=SP, encoder_depth=depth, encoder_width=(8, 16, 16)[:stages],
                strides=(1, 2, 2)[:stages], decoder_depth=depth[1:], mlp_ratio=2, rank=1, num_iters=3,
                init_method="uniform", solver="hals", reshape=(lib.SWMatricize, SW))
    args.update(kw)
    if lib is ftt:
        args.update(device="cpu", generator=torch.Generator().manual_seed(1))
    return lib.Factorizer(**args)


# name -> (options for both libraries as a function of the library, stages, train, input channels-last).
FACTORIZER_CASES = {
    "deep2_overrides_train": (lambda lib: dict(
        num_deep_supr=2, dropout=0.0, stem=(lib.DoubleConv, {"act": "relu"}),
        downsample=(lib.Conv, {"kernel_size": 3, "padding": 1}), upsample=(lib.ConvTranspose, {"bias": False}),
        head=(lib.Conv, {"kernel_size": 1, "bias": False})), 2, True, False),
    "deep_true_channels_last": (lambda lib: dict(num_deep_supr=True, data_format="channels_last"), 3, False, True),
    "dropout_eval": (lambda lib: dict(dropout=0.3), 2, False, False),
    "identity_stem": (lambda lib: dict(in_channels=8, stem=lib.Identity), 2, False, False),
}


@pytest.mark.parametrize("name", list(FACTORIZER_CASES))
def test_factorizer_options_match_jax(name):
    """The Factorizer's skeleton options: heads ``head{j}`` (2, and True for 3) returned as a list, a DoubleConv stem,
    k3 downsampling, bias-free k2 upsampling and k1 heads, channels-last input and outputs, no stem (the input's
    width is the first stage's); ``dropout=0`` in training mode equals JAX's ``train=True`` and ``dropout=0.3`` in
    evaluation mode JAX's deterministic call, f64 to 1e-10."""
    options, stages, train, channels_last = FACTORIZER_CASES[name]
    model_j, model_t = factorizer(ftx, stages, **options(ftx)), factorizer(ftt, stages, **options(ftt))
    c = 8 if name == "identity_stem" else 4
    shape = (2, *SP, c) if channels_last else (2, c, *SP)
    check_float64(model_j, model_t, _input(shape), train=train)
    heads = [n for n, _ in model_t.named_children() if n.startswith("head")]
    assert heads == (["head0", "head1"] if name.startswith("deep2") else ["head0", "head1", "head2"]
                     if name.startswith("deep_true") else ["head"])
    assert (name != "identity_stem") == bool(list(model_t.stem.parameters()))


def _deconver(lib, **kw):
    args = dict(spatial_dims=3, encoder_depth=(1, 1), encoder_width=(8, 16), strides=(1, 2), decoder_depth=(1,),
                norm=lib.LayerNorm, act="relu", groups=-1, ratio=1, num_iters=2)
    args.update(kw)
    if lib is ftt:
        args.update(device="cpu", generator=torch.Generator().manual_seed(1))
    return lib.Deconver(4, 3, **args)


def test_deconver_patch_stem_and_heads_match_jax():
    """The Deconver with the patch-embedding ``Stem`` (k2 s2 convolution and LayerNorm) as its stem spec, two heads
    and dropout 0 in training mode, f64 to 1e-10; the bridge maps ``stem.conv`` and ``stem.norm``."""
    model_j = _deconver(ftx, stem=(ftx.Stem, {"patch_size": (2, 2, 2)}), num_deep_supr=2, dropout=0.0)
    model_t = _deconver(ftt, stem=(ftt.Stem, {"patch_size": (2, 2, 2)}), num_deep_supr=2, dropout=0.0)
    variables = check_float64(model_j, model_t, _input((2, 4, *SP)), train=True)
    assert set(variables["params"]["unet"]["stem"]) == {"conv", "norm"}
    assert isinstance(model_t.stem, ftt.Stem) and model_t.slab_path_missing() is None


def _unet(lib, in_channels: int = 4, **kw):
    args = dict(encoder_depth=(1, 1), encoder_width=(8, 16), strides=(1, 2), decoder_depth=(1,),
                stem=(lib.Conv, {"kernel_size": 3, "padding": 1}))
    args.update(kw)
    if lib is ftt:
        args.update(device="cpu", generator=torch.Generator().manual_seed(1))
    return lib.UNet(in_channels, 3, **args)


UNET_CASES = {
    "spec": lambda lib: dict(block=lib.DoubleConv),
    "same": lambda lib: dict(block=lib.Same((lib.DoubleConv, {"act": "relu"}))),
    "list": lambda lib: dict(block=[(lib.DoubleConv, {}), (lib.BasicBlock, {}), (lib.PreActivationBlock, {})],
                             num_deep_supr=2),
    "default_block_no_stem": lambda lib: dict(in_channels=8, stem=None),
    "factorizer_stages_conv_adapter": lambda lib: dict(
        spatial_size=SP, block=lib.Same((lib.FactorizerStage, {
            "adapter": (lib.Conv, {"kernel_size": 1}), "mlp_ratio": 2, "rank": 1, "num_iters": 3,
            "init_method": "uniform", "reshape": (lib.SWMatricize, SW)} if lib is ftx else {
            "adapter": (lib.Conv, {"kernel_size": 1}), "mlp_ratio": 2, "factorize_kwargs": {
                "rank": 1, "num_iters": 3, "init_method": "uniform"}, "reshape": (lib.SWMatricize, SW)}))),
}


@pytest.mark.parametrize("name", list(UNET_CASES))
def test_unet_block_specs_match_jax(name):
    """The generic UNet: ``block`` as one spec, as ``Same`` and as a list (DoubleConv, BasicBlock,
    PreActivationBlock, with two heads), the default DoubleConv block without a stem, and FactorizerStage blocks with
    a k1-convolution ``adapter``; f64 to 1e-10, the variables at the top level (no ``unet``)."""
    model_j, model_t = _unet(ftx, **UNET_CASES[name](ftx)), _unet(ftt, **UNET_CASES[name](ftt))
    c = 8 if name == "default_block_no_stem" else 4
    check_float64(model_j, model_t, _input((2, c, *SP)))
    assert model_t.slab_path_missing() is None


def test_unet_stem_none_needs_matching_widths():
    """``stem=None`` leaves the input's width to the stride-1 first stage: both packages raise JAX's ValueError
    where they differ."""
    message = "stride-1 encoder stage requires matching widths"
    with pytest.raises(ValueError, match=message):
        init_variables(_unet(ftx, stem=None), _input((1, 4, *SP)))
    with pytest.raises(ValueError, match=message):
        _unet(ftt, stem=None)
    with pytest.raises(ValueError, match=message):
        _unet(ftt, stem=ftt.Identity)


MLP_CASES = {
    "out_channels": dict(out_channels=12),
    "hidden_channels": dict(hidden_channels=20, ratio=5),
    "bias_free": dict(bias=False, dropout=(0.0, 0.0)),
}


@pytest.mark.parametrize("name", list(MLP_CASES))
def test_mlp_options_match_jax(name):
    """``MLP`` with ``out_channels``, ``hidden_channels`` and ``bias=False``, f64 to 1e-10; fc1 / fc2 at ``block.0``
    / ``block.3``; a bias-free MLP has no bias entries."""
    kw = MLP_CASES[name]
    model_j = ftx.MLP(8, **kw)
    model_t = ftt.MLP(8, **kw, generator=torch.Generator().manual_seed(1))
    check_float64(model_j, model_t, _input((2, 5, 8)), call=lambda m, v, a: m.apply(v, a))
    keys = set(model_t.state_dict())
    assert {"block.0.linear.weight", "block.3.linear.weight"} <= keys
    assert any(k.endswith("bias") for k in keys) == (name != "bias_free")
    assert model_t.hidden_channels == {"hidden_channels": 20}.get(name, 24)


class _Tail:
    """A JAX LayerNorm and MLP as a block's tail ``x + mlp(norm(x))``."""

    def __init__(self, **mlp):
        import flax.linen as fnn

        class Tail(fnn.Module):
            @fnn.compact
            def __call__(self, x):
                return x + ftx.MLP(32, name="mlp", **mlp)(ftx.LayerNorm(32, name="norm2")(x))

        self.module = Tail()


def test_bias_free_tail_takes_k2_plain_and_matches_jax(monkeypatch):
    """A bias-free MLP's tail goes through K2's wrapper (here its plain version) with zero biases that keep no
    gradient, and equals the JAX tail in f64 to 1e-10, input and parameter gradients too."""
    tail_j = _Tail(ratio=2, bias=False).module
    x = _input((2, 6, 32))
    variables = init_variables(tail_j, x)
    norm2, mlp = ftt.LayerNorm(32), ftt.MLP(32, ratio=2, bias=False)
    params = variables["params"]
    with torch.no_grad():
        norm2.norm.weight.copy_(torch.tensor(params["norm2"]["norm"]["scale"]))
        norm2.norm.bias.copy_(torch.tensor(params["norm2"]["norm"]["bias"]))
        mlp.fc1.linear.weight.copy_(torch.tensor(params["mlp"]["fc1"]["linear"]["kernel"].T))
        mlp.fc2.linear.weight.copy_(torch.tensor(params["mlp"]["fc2"]["linear"]["kernel"].T))
    norm2.double(), mlp.double()
    assert prenorm_mlp_reason(norm2, mlp) is None and mlp.fc1.linear.bias is None
    seen = []
    k2 = port_basic.prenorm_mlp
    monkeypatch.setattr(port_basic, "prenorm_mlp", lambda *a: seen.append(a) or k2(*a))
    xt = torch.from_numpy(x).double().requires_grad_(True)
    y = prenorm_mlp_tail(norm2, mlp, xt)
    (b1, b2) = seen[0][4], seen[0][6]
    assert not b1.requires_grad and not b2.requires_grad and not b1.any() and not b2.any()
    r = np.random.default_rng(2).standard_normal(y.shape)
    (y * torch.from_numpy(r)).sum().backward()
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        xj = jnp.asarray(x, jnp.float64)
        want = np.asarray(tail_j.apply(v64, xj))
        gx, gp = jax.grad(lambda a, p: jnp.sum(tail_j.apply({"params": p}, a) * r), argnums=(0, 1))(xj, v64["params"])
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0, atol=F64_TOL * np.abs(want).max())
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0, atol=F64_TOL * np.abs(gx).max())
    for got, want in ((mlp.fc1.linear.weight.grad, gp["mlp"]["fc1"]["linear"]["kernel"].T),
                      (mlp.fc2.linear.weight.grad, gp["mlp"]["fc2"]["linear"]["kernel"].T),
                      (norm2.norm.weight.grad, gp["norm2"]["norm"]["scale"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64_TOL * np.abs(want).max())


# name -> (norm, MLP options, training mode, the reason's start or None for K2).
K2_RULE = {
    "layernorm": (ftt.LayerNorm, 32, dict(ratio=2), False, None),
    "bias_free": (ftt.LayerNorm, 32, dict(ratio=2, bias=False), True, None),
    "dropout_zero_training": (ftt.LayerNorm, 32, dict(ratio=2, dropout=0.0), True, None),
    "dropout_evaluation": (ftt.LayerNorm, 32, dict(ratio=2, dropout=0.1), False, None),
    "dropout_training": (ftt.LayerNorm, 32, dict(ratio=2, dropout=0.1), True, "active dropout"),
    "dropout_second_site": (ftt.LayerNorm, 32, dict(ratio=2, dropout=(0.0, 0.1)), True, "active dropout"),
    "instance_norm": (ftt.InstanceNorm, 32, dict(ratio=2), False, "norm is InstanceNorm"),
    "not_residual": (ftt.LayerNorm, 32, dict(ratio=2, out_channels=64), False, "the MLP is not shape-preserving"),
    "hidden_not_32": (ftt.LayerNorm, 32, dict(hidden_channels=48), False, "hidden width 48"),
    "width_not_k2s": (ftt.LayerNorm, 48, dict(ratio=2), False, "C=48"),
}


@pytest.mark.parametrize("name", list(K2_RULE))
def test_k2_routing_rule(name):
    """K2 takes a tail exactly when the norm is LayerNorm, the MLP keeps the width, no dropout is active, C is one of
    K2's widths and 32 divides the hidden width (JAX's ``_fused_prenorm_mlp_reason`` without its TPU checks)."""
    norm, c, kw, training, reason = K2_RULE[name]
    norm2, mlp = norm(c), ftt.MLP(c, **kw).train(training)
    got = prenorm_mlp_reason(norm2, mlp)
    assert (got is None) if reason is None else got.startswith(reason), got


def _sites(model) -> dict:
    return {name: m for name, m in model.named_modules() if isinstance(m, torch.nn.Dropout)}


@pytest.mark.parametrize("family", ["factorizer", "deconver"])
def test_dropout_keep_rate_and_scale(family):
    """p = 0.25 in training mode: at every site (the mixer's, the MLP's two, the bottleneck's ``pos_drop``) the share
    of entries kept lies within five standard deviations of 0.75 and each kept entry is its input over 0.75; in
    evaluation mode every site is the identity."""
    p = 0.25
    model = (factorizer(ftt, 2, dropout=p, encoder_width=(32, 32)) if family == "factorizer"
             else _deconver(ftt, dropout=p, encoder_width=(32, 32)))
    sites, seen = _sites(model), {}
    expected = {"fact.drop", "mlp.block.2", "mlp.block.4", "pos_drop"} if family == "factorizer" else {
        "dcm.drop", "mlp.block.2", "mlp.block.4"}
    assert all(any(n.endswith(site) for n in sites) for site in expected)
    for name, m in sites.items():
        m.register_forward_hook(lambda mod, args, out, name=name: seen.__setitem__(name, (args[0], out)))
    x = torch.from_numpy(_input((2, 4, *SP)))
    torch.manual_seed(0)
    model.train()(x)
    assert seen.keys() == sites.keys()
    for name, (inp, out) in seen.items():
        nonzero = inp != 0
        kept = (out != 0) & nonzero
        n = int(nonzero.sum())
        share = int(kept.sum()) / n
        assert abs(share - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n), (name, share)
        torch.testing.assert_close(out[kept], inp[kept] / (1 - p), rtol=1e-6, atol=0)
    seen.clear()
    with torch.no_grad():
        model.eval()(x)
    assert all(torch.equal(out, inp) for inp, out in seen.values())


def test_active_dropout_steps_aside_from_k2(monkeypatch):
    """A train step of a Factorizer at K2's widths with dropout 0.1 sends no block tail to K2's wrapper; its eval
    forward sends all three; with dropout 0 the train step sends all three too."""
    calls = []
    k2 = port_basic.prenorm_mlp
    monkeypatch.setattr(port_basic, "prenorm_mlp", lambda *a: calls.append(1) or k2(*a))
    x = torch.from_numpy(_input((2, 4, *SP)))
    y = torch.from_numpy((np.random.default_rng(3).random((2, 3, *SP)) > 0.7).astype(np.float32))
    for p, want in ((0.1, 0), (0.0, 3)):
        model = factorizer(ftt, 2, dropout=p, encoder_width=(32, 32))
        state = port_trainer.create_train_state(model, device="cpu", lr=1e-3)
        calls.clear()
        port_trainer.make_train_step(state.model)(state, {"image": x, "label": y})
        assert len(calls) == want and state.model.training
        calls.clear()
        with torch.no_grad():
            model.eval()(x)
        assert len(calls) == 3


def test_split_shifts_matches_jax():
    """``factorize_options={"use_windowed": False, "split_shifts": True}``: the port's per-shift route against the JAX
    model's, f64 to 1e-10 (logits and every gradient)."""
    opts = {"use_windowed": False, "split_shifts": True}
    model_t = factorizer(ftt, 2, factorize_options=opts)
    assert all(m.splits_shifts and m.windowed is None for m in model_t.modules() if isinstance(m, ftt.FactMixer))
    check_float64(factorizer(ftx, 2, factorize_options=opts), model_t, _input((2, 4, *SP)))


def test_split_shifts_equals_concat_route_bit_for_bit():
    """The split route and the concatenated flat route from the same weights, f32: the same logits and loss bit for
    bit, and the gradients to 1e-6 of the largest (autograd sums the shifts' cotangents in its own order)."""
    x = torch.from_numpy(_input((2, 4, *SP)))
    y = torch.from_numpy((np.random.default_rng(4).random((2, 3, *SP)) > 0.7).astype(np.float32))
    results = []
    for opts in ({"use_windowed": False}, {"use_windowed": False, "split_shifts": True}):
        model = factorizer(ftt, 2, factorize_options=opts)
        logits = model(x)
        loss = ftt.dice_ce_loss(logits, y)
        loss.backward()
        results.append((logits.detach(), loss.detach(), {k: p.grad for k, p in model.named_parameters()}))
    (l0, s0, g0), (l1, s1, g1) = results
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    largest = max(g.abs().max() for g in g0.values())
    for key in g0:
        assert (g0[key] - g1[key]).abs().max() <= 1e-6 * largest, key


def test_split_shifts_leaves_a_k1_mixer_on_k1():
    """A mixer that K1 computes keeps K1 under ``split_shifts`` (JAX checks its fused kernel first)."""
    m = ftt.FactMixer(8, 8, SP, reshape=(ftt.SWMatricize, SW), factorize_kwargs={"rank": 1},
                      factorize_options={"split_shifts": True})
    assert m.windowed == (4, 4, (None, (1, 1, 1), (2, 2, 2), (3, 3, 3))) and not m.splits_shifts


def test_remat_replays_the_dropout_masks():
    """``remat=True`` with dropout 0.2: one train step from the same weights and the same seed gives the loss and
    every gradient of the step without remat, bit for bit (checkpoint restores the random state for the recompute)."""
    x = torch.from_numpy(_input((2, 4, *SP)))
    y = torch.from_numpy((np.random.default_rng(5).random((2, 3, *SP)) > 0.7).astype(np.float32))
    results = []
    for remat in (False, True):
        model = factorizer(ftt, 2, dropout=0.2, remat=remat).train()
        torch.manual_seed(11)
        loss = ftt.dice_ce_loss(model(x), y)
        loss.backward()
        results.append((loss.detach(), {k: p.grad for k, p in model.named_parameters()}))
    (loss, grads), (loss_r, grads_r) = results
    assert torch.equal(loss, loss_r)
    for key in grads:
        assert torch.equal(grads[key], grads_r[key]), key


def test_ensemble_predict_takes_the_first_head():
    """``ensemble_predict`` on a model with two heads equals the same weights in a one-head model whose ``head`` is
    ``head0``, bit for bit, and hands the model back in training mode."""
    deep = factorizer(ftt, 2, num_deep_supr=2).train()
    single = factorizer(ftt, 2)
    state = {k.replace("head0.", "head."): v for k, v in deep.state_dict().items() if not k.startswith("head1.")}
    single.load_state_dict(state)
    image = torch.from_numpy(_input((1, 4, 24, 16, 20)))
    mask, probs = ftt.ensemble_predict([deep], image, SP, sw_batch_size=2)
    mask1, probs1 = ftt.ensemble_predict([single], image, SP, sw_batch_size=2)
    assert probs.shape == (1, 3, 24, 16, 20) and torch.equal(probs, probs1) and torch.equal(mask, mask1)
    assert deep.training


THREE_STAGES = {
    "roi_size": [16, 16, 16],
    "network_def#encoder_depth": [1, 1, 1],
    "network_def#encoder_width": [8, 16, 16],
    "network_def#strides": [1, 2, 2],
    "network_def#decoder_depth": [1, 1],
    "network_def#num_iters": 3,
    "network_def#reshape": ["$ftx.SWMatricize", {"head_dim": 4, "patch_size": 4, "shifts": [None, 2]}],
    "network_def#num_deep_supr": 3,
    "network_def#dropout": 0.0,
}


def test_bundle_network_def_with_heads_and_dropout():
    """factorizer_brats23's ``network_def`` with ``num_deep_supr: 3, dropout: 0.0`` (three stages at 16^3) through
    the port's config parser: it builds three heads, and the train step's loss (the deep-supervision DiceCE) equals
    the JAX model's in training mode to 1e-10, f64."""
    model_j = jax_config.ConfigParser(bundle_config("factorizer_brats23", **THREE_STAGES))["network_def"]
    model_t = ConfigParser(bundle_config("factorizer_brats23", **THREE_STAGES, **{"network_def#device": "cpu"}))[
        "network_def"]
    assert type(model_t) is ftt.Factorizer and model_t.head_names() == ["head0", "head1", "head2"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, *SP))
    y = (rng.random((2, 3, *SP)) > 0.7).astype(np.float64)
    variables = init_variables(model_j, x.astype(np.float32))
    assert_bridge_both_ways(model_t, variables)
    ftt.load_flax_variables(model_t, variables)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want = float(jax.jit(lambda v: jax_losses.deep_supervision_loss(
            model_j.apply(v, jnp.asarray(x), train=True), jnp.asarray(y)))(v64))
    state = port_trainer.create_train_state(model_t.double(), device="cpu", lr=0.0)
    _, metrics = port_trainer.make_train_step(state.model)(state, {"image": torch.from_numpy(x),
                                                                   "label": torch.from_numpy(y)})
    assert metrics["loss"].dtype == torch.float64
    np.testing.assert_allclose(metrics["loss"].item(), want, rtol=F64_TOL)
