"""Port parity: the network_def keys that select the factorization engine, and the kernels' routing rules.

* The routing grid: the port's ``FactMixer`` takes K1 exactly when the JAX package's ``_fused_fallback_reason``
  (``factorize_options={"use_windowed": True}``, so the platform does not decide) returns None, and
  ``MatrixFactorization`` takes K4 exactly when JAX's ``_fused_eligible`` (``use_pallas=True``) holds.  On the CPU
  "takes" is the route the module chose, read from it (``FactMixer.windowed``, ``MatrixFactorization.supports``).
* ``factorize_options``: a key the factorizer's class accepts reaches it, as in the JAX package (``use_pallas``
  too, while ``explain`` stays with the mixer); ``split_shifts`` is the mixer's.
* ``use_pallas: False``, JAX's pure-XLA mode, on a reduced Factorizer and a bare ``MatrixFactorization`` against
  JAX's in f64, with neither K1's nor K4's route taken; ``explain``'s reasons against JAX's
  ``_fused_fallback_reason``, logged once per reason, and every forward under ``explain: True``.
* ``factorizer_brats23``'s ``network_def`` with the override sets (a)-(g) at roi 8^3, through the port's
  ``ConfigParser`` and JAX's: every ``$ftx.`` name resolves, the two models agree through the weight bridge (the
  randomized SVD's test matrix is JAX's draw in both), and every set has a slab path (the flat route of (a)-(d)
  runs on the gathered tensor).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
import factorizer_tpu_torch as ftt
from factorizer_tpu import config as jax_config
from factorizer_tpu.utils.torch_import import convert_state_dict
from factorizer_tpu_torch.config import ConfigParser
from factorizer_tpu_torch.factorization import svd as svd_module
from factorizer_tpu_torch.utils.weights import flax_state_dict
from torch_bundle_cases import TINY_FACTORIZER, bundle_config

torch.set_num_threads(1)

SW = {"head_dim": 4, "patch_size": 4, "shifts": [None, 2]}
# name -> (spatial size, reshape options, factorizer options): each departs from the K1 default in one place.
ROUTES = {
    "default": ((8, 8, 8), {}, {}),
    "mu": ((8, 8, 8), {}, {"solver": "mu"}),
    "normal": ((8, 8, 8), {}, {"init_method": "normal"}),
    "normal-uniform": ((8, 8, 8), {}, {"init_method": "normal-uniform"}),
    "svd": ((8, 8, 8), {}, {"init_method": "svd"}),
    "nndsvd": ((8, 8, 8), {}, {"init_method": "nndsvd"}),
    "nncd": ((8, 8, 8), {}, {"solver": "nncd"}),
    "cd": ((8, 8, 8), {}, {"solver": "cd"}),
    "hals-0": ((8, 8, 8), {}, {"solver": "hals-0"}),
    "composed": ((8, 8, 8), {}, {"solver": ["hals"]}),
    "class-spec": ((8, 8, 8), {}, {"solver": "CoordinateDescent+relu"}),
    "nnls": ((8, 8, 8), {}, {"solver": "nnls"}),
    "fmu": ((8, 8, 8), {}, {"solver": "fmu"}),
    "project": ((8, 8, 8), {}, {"project": "relu"}),
    "rank2": ((8, 8, 8), {}, {"rank": 2}),
    "compression10": ((8, 8, 8), {}, {"rank": None, "compression": 10.0}),
    "compression1": ((8, 8, 8), {}, {"rank": None, "compression": 1.0}),
    "2d": ((8, 8), {}, {}),
    "2d-rank4": ((8, 8), {}, {"rank": 4}),
    "non-cubic": ((8, 8, 8), {"patch_size": (4, 4, 2)}, {}),
    "non-cubic-grid": ((8, 8, 12), {"patch_size": 4}, {}),
    "no-shift": ((8, 8, 8), {"shifts": [None]}, {}),
    "svd-mu-rank2": ((8, 8, 8), {}, {"init_method": "svd", "solver": "mu", "rank": 2}),
}


def _relu(package):
    return jax.nn.relu if package is ftx else torch.relu


def _options(package, opts):
    base = dict(rank=1, num_iters=3, init_method="uniform", solver="hals")
    base.update(opts)
    if base.get("project") == "relu":
        base["project"] = _relu(package)
    if base["solver"] == "CoordinateDescent+relu":  # HALS given as (class, kwargs): not the string "hals"
        base["solver"] = (package.CoordinateDescent, {"project": _relu(package)})
    return base


@pytest.mark.parametrize("case", list(ROUTES))
def test_routing_matches_jax(case):
    """K1 for the mixer exactly when JAX's rule gives no reason; K4 for its factorizer exactly when JAX's holds."""
    spatial, reshape_opts, opts = ROUTES[case]
    c = 8
    reshape = {**SW, **reshape_opts}
    fact_t = _options(ftt, opts)
    fact_j = _options(ftx, opts)
    project_j = fact_j.pop("project", None)
    project_t = fact_t.pop("project", None)
    factorize_j = (ftx.NMF, {"project": project_j}) if project_j is not None else ftx.NMF
    factorize_t = (ftt.NMF, {"project": project_t}) if project_t is not None else ftt.NMF
    m_j = ftx.FactMixer(c, c, spatial, reshape=(ftx.SWMatricize, reshape), factorize=factorize_j,
                        factorize_options={"use_windowed": True}, **fact_j)
    out = jnp.zeros((2, *spatial, c))
    reason, _ = m_j.init_with_output(jax.random.key(0), out, method=lambda m, out: m._fused_fallback_reason(out))
    m_t = ftt.FactMixer(c, c, spatial, reshape=(ftt.SWMatricize, reshape), factorize=factorize_t,
                        factorize_kwargs=fact_t)
    assert (m_t.windowed is not None) == (reason is None), (case, reason)

    size = tuple(m_t.reshape.output_size[2:])
    mf_j = ftx.MatrixFactorization(size=size, use_pallas=True, **{**fact_j, "project": project_j})
    eligible, _ = mf_j.init_with_output(jax.random.key(0), method=lambda m: m._fused_eligible())
    mf_t = ftt.MatrixFactorization(size, **{**fact_t, "project": project_t})
    assert mf_t.supports() == eligible, case
    if eligible:  # no configuration with another init, a projection or another solver reaches the kernels
        assert isinstance(mf_t.init, ftt.RandomInit) and mf_t.solver in ("hals", "mu") and mf_t.project is None


def test_factorize_options_reach_the_factorizer():
    """F7: every key the factorizer's class takes is passed (``eps``, ``init`` read as ``init_method``,
    ``compression``, ``seed``), ``factorize_options`` before the model's own fields, as JAX's ``FactMixer`` does (an
    ``init_method`` field wins over an ``init`` key there too); a key no class takes is dropped; ``use_pallas``
    reaches the factorizer and ``explain`` stays with the mixer, as JAX's keys do; ``split_shifts`` is taken by a flat-route mixer (here a rank-2 one's) and is no factorizer's key, and the
    split route equals the concat route bit for bit."""
    sw = (ftt.SWMatricize, SW)
    m = ftt.FactMixer(8, 8, (8, 8, 8), reshape=sw, factorize_kwargs={"rank": 1, "num_iters": 5},
                      factorize_options={"eps": 1e-8, "init": "nndsvd", "num_iters": 2, "not_a_key": 1})
    assert m.factorize.eps == 1e-8 and m.factorize.solver_.eps == 1e-8 and m.factorize.num_iters == 2
    assert isinstance(m.factorize.init, ftt.NNDSVDInit) and m.windowed is None
    m = ftt.FactMixer(8, 8, (8, 8, 8), reshape=sw, factorize_kwargs={"rank": 1, "init_method": "uniform"},
                      factorize_options={"init": "nndsvd"})
    assert isinstance(m.factorize.init, ftt.RandomInit) and m.windowed is not None
    m = ftt.FactMixer(8, 8, (8, 8, 8), reshape=sw, factorize_kwargs={"rank": None},
                      factorize_options={"eps": 1e-8, "compression": 10.0})
    assert m.factorize.rank_ == 1 and m.windowed is not None and m.factorize.kernel_eps == 1e-8
    m = ftt.FactMixer(8, 8, (8, 8, 8), reshape=sw, factorize=ftt.SVD, factorize_kwargs={"rank": 2, "solver": "hals"},
                      factorize_options={"seed": 7})
    assert isinstance(m.factorize, ftt.SVD) and (m.factorize.rank, m.factorize.seed) == (2, 7) and m.windowed is None
    assert ftt.has_args(ftt.NMF, "rank") and ftt.spec_accepts((ftt.NMF, {}), "compression")
    for value in (False, True, None):  # JAX's kernel keys: use_pallas reaches the factorizer, explain the mixer alone
        m = ftt.FactMixer(8, 8, (8, 8, 8), reshape=sw, factorize_kwargs={"rank": 1},
                          factorize_options={"use_pallas": value, "explain": True})
        assert m.factorize.use_pallas is value and m.explain and not hasattr(m.factorize, "explain")
        assert (m.windowed is None) == (value is False) and m.factorize.supports() == (value is not False)
    fk = {"rank": 2, "num_iters": 2}
    concat = ftt.FactMixer(8, 8, (8, 8, 8), reshape=sw, factorize_kwargs=fk)
    split = ftt.FactMixer(8, 8, (8, 8, 8), reshape=sw, factorize_kwargs=fk, factorize_options={"split_shifts": True})
    split.load_state_dict(concat.state_dict())
    assert split.splits_shifts and split.windowed is None and not hasattr(split.factorize, "split_shifts")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 8, 8, 8, 8)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(split(x), concat(x))
    with pytest.raises(NotImplementedError, match="KMeans"):
        ftt.FactMixer(8, 8, (8, 8, 8), reshape=sw, factorize=ftt.KMeans)


def _jax_draw(shape, dtype, device, seed):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return torch.from_numpy(np.array(jax.random.normal(jax.random.key(seed), tuple(shape), jdt))).to(device)


SMALL = {**TINY_FACTORIZER, "roi_size": [8, 8, 8], "network_def#num_iters": 3}
OVERRIDES = {
    "a-nndsvd": {"network_def#init_method": "nndsvd"},
    "b-nnls": {"network_def#solver": "nnls"},
    "c-composed": {"network_def#solver": ["hals-0", "mu-1"]},
    "d-svd": {"network_def#factorize": "$ftx.SVD"},
    "e-compression": {"network_def#rank": None, "network_def#compression": 10},
    "f-sinusoidal": {"network_def#pos_embed": "$ftx.SinusoidalPositionalEmbedding"},
    "f-rotary": {"network_def#pos_embed": "$ftx.RotaryPositionalEmbedding"},
    "f-axial": {"network_def#pos_embed": "$ftx.AxialPositionalEmbedding"},
    "g-eps": {"network_def#factorize_options": {"eps": 1.0e-8}},
}


@pytest.fixture(scope="module")
def default_variables():
    """The JAX variables of the bundle's reduced ``network_def`` (``init`` from key 0): every set but the axial one
    has these parameters; the sets with an SVD or NNDSVD init, or ``SVD``, have no ``RandomInit`` buffers."""
    model_j = jax_config.ConfigParser(bundle_config("factorizer_brats23", **SMALL))["network_def"]
    return jax.tree.map(np.asarray, dict(model_j.init(jax.random.key(0), jnp.zeros((1, 4, 8, 8, 8)))))


@pytest.mark.parametrize("name", list(OVERRIDES))
def test_bundle_overrides_match_jax(name, monkeypatch, default_variables):
    """The bundle's ``network_def`` with one override set, built by both parsers: the port's classes resolve, the
    JAX variables load through the bridge, and the float32 logits agree within 1e-4 of the largest; (a)-(d) take the
    flat route, (e)-(g) K1 on every mixer.  The JAX model runs jitted where it takes the SVD (a whole-graph compile
    costs less than compiling each linear-algebra call on its own)."""
    monkeypatch.setattr(svd_module, "gaussian", _jax_draw)
    overrides = {**SMALL, **OVERRIDES[name]}
    model_j = jax_config.ConfigParser(bundle_config("factorizer_brats23", **overrides))["network_def"]
    model_t = ConfigParser(bundle_config("factorizer_brats23", **overrides, **{"network_def#device": "cpu"}))["network_def"]
    mixers = [m for m in model_t.modules() if isinstance(m, ftt.FactMixer)]
    assert type(model_t) is ftt.Factorizer and len(mixers) == 3
    if name == "d-svd":
        assert all(type(m.factorize) is ftt.SVD for m in mixers)
    if name.startswith("f-"):
        cls = getattr(ftt, overrides["network_def#pos_embed"].removeprefix("$ftx."))
        assert [type(m) for m in model_t.modules() if isinstance(m, cls)] == [cls]
    flat = name[0] in "abcd"
    assert all((m.windowed is None) == flat for m in mixers)
    assert model_t.slab_path_missing() is None
    x = np.random.default_rng(0).standard_normal((1, 4, 8, 8, 8)).astype(np.float32)
    if name == "f-axial":
        variables = jax.tree.map(np.asarray, dict(model_j.init(jax.random.key(0), jnp.asarray(x))))
    elif name in ("a-nndsvd", "d-svd"):
        variables = {"params": default_variables["params"]}
    else:
        variables = default_variables
    ftt.load_flax_variables(model_t, variables)
    apply = jax.jit(model_j.apply) if name in ("a-nndsvd", "d-svd") else model_j.apply
    want = np.asarray(apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model_t(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 3, 8, 8, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_bridge_round_trip_axial_tables_and_bufferless_mixers():
    """The bridge maps the axial tables ``pe{i}`` ((1, *, C) -> (1, C, *)), and maps nothing for mixers without
    tables (an NNDSVD init): the JAX tree without its ``initializer`` buffers loads into such a model leaf for leaf,
    and goes back through ``convert_state_dict`` where that has a rule (every leaf but the axial tables)."""
    kw = dict(in_channels=4, out_channels=3, spatial_size=(8, 8, 8), encoder_depth=(1, 1), encoder_width=(8, 16),
              strides=(1, 2), decoder_depth=(1,), rank=1, num_iters=2)
    model_j = ftx.Factorizer(**kw, reshape=(ftx.SWMatricize, SW), pos_embed=ftx.AxialPositionalEmbedding)
    variables = jax.tree.map(np.asarray, dict(model_j.init(jax.random.key(0), jnp.zeros((1, 4, 8, 8, 8)))))
    model_t = ftt.Factorizer(**kw, init_method="nndsvd", reshape=(ftt.SWMatricize, SW),
                             pos_embed=ftt.AxialPositionalEmbedding, device="cpu")
    assert not [k for k in model_t.state_dict() if ".init." in k]
    ftt.load_flax_variables(model_t, {"params": variables["params"]})
    pe = variables["params"]["unet"]["enc1"]["pos_embed_"]
    for i in range(3):
        got = model_t.state_dict()[f"encoder.blocks.1.block.pos_embed.pe{i}"]
        np.testing.assert_array_equal(got.numpy(), np.moveaxis(pe[f"pe{i}"], -1, 1))
    back = convert_state_dict({k: v for k, v in model_t.state_dict().items() if ".pe" not in k})
    assert "buffers" not in back
    want = dict(_leaves({k: v for k, v in variables["params"]["unet"].items()}))
    got = dict(_leaves(back["params"]["unet"]))
    assert got.keys() == {k for k in want if ".pe" not in k and not k.startswith("enc1.pos_embed_")}
    for key, value in got.items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield ".".join((*prefix, k)), np.asarray(v)


# -- use_pallas: False (JAX's pure-XLA mode) and explain


F64_TOL = 1e-10
PURE_XLA = dict(in_channels=4, out_channels=3, spatial_size=(8, 8, 8), encoder_depth=(1, 1), encoder_width=(8, 16),
                strides=(1, 2), decoder_depth=(1,), rank=1, num_iters=3, init_method="uniform", solver="hals")


def _no_kernel_routes(monkeypatch):
    """Neither K1's nor K4's route may be taken (their wrappers raise if reached; K5's too)."""
    from factorizer_tpu_torch.factorization import nmf as port_nmf
    from factorizer_tpu_torch.models import factorizer as port_factorizer

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel route was taken under use_pallas: False")

    for module, name in ((port_factorizer, "windowed_nmf"), (port_factorizer, "windowed_nmf_multi_spatial"),
                         (port_nmf.nmf_kernel, "nmf_reconstruct")):
        monkeypatch.setattr(module, name, refuse)


def _close64(got: torch.Tensor, want: np.ndarray, scale: float) -> None:
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=F64_TOL * scale)


def test_use_pallas_false_factorizer_matches_jax_pure_xla(monkeypatch):
    """A reduced Factorizer under ``factorize_options={"use_pallas": False}`` against JAX's same model (its pure-XLA
    mode), f64: the logits and every parameter gradient of ``sum(out * r)`` to 1e-10 of the largest; every mixer on
    the flat route with its factorizer off K4, and neither kernel's wrapper reached."""
    sw = {"head_dim": 4, "patch_size": 4, "shifts": [None, 2]}
    options = {"use_pallas": False}
    model_j = ftx.Factorizer(**PURE_XLA, reshape=(ftx.SWMatricize, sw), factorize_options=options)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 4, 8, 8, 8))
    variables = jax.tree.map(np.asarray, dict(jax.jit(model_j.init)(jax.random.key(0), jnp.zeros((1, 4, 8, 8, 8)))))
    r = rng.standard_normal((2, 3, 8, 8, 8))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def loss(p):
            out = model_j.apply({**v64, "params": p}, jnp.asarray(x))
            return jnp.sum(out * r), out

        (_, out_j), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v64["params"])
        out_j, grads = np.asarray(out_j), jax.tree.map(np.asarray, grads)
    model_t = ftt.Factorizer(**PURE_XLA, reshape=(ftt.SWMatricize, sw), factorize_options=options, device="cpu")
    ftt.load_flax_variables(model_t, variables).double()
    mixers = [m for m in model_t.modules() if isinstance(m, ftt.FactMixer)]
    assert len(mixers) == 3 and all(m.windowed is None and not m.factorize.supports() for m in mixers)
    _no_kernel_routes(monkeypatch)
    out_t = model_t(torch.from_numpy(x))
    _close64(out_t, out_j, np.abs(out_j).max())
    (out_t * torch.from_numpy(r)).sum().backward()
    want = flax_state_dict(model_t, {**variables, "params": grads})
    named = dict(model_t.named_parameters())
    largest = max(np.abs(want[k].numpy()).max() for k in named)
    for key, p in named.items():
        _close64(p.grad, want[key].numpy(), largest)


def test_use_pallas_false_matrix_factorization_matches_jax(monkeypatch):
    """A bare ``MatrixFactorization`` (HALS, rank 1, a K4 size) with ``use_pallas=False`` against JAX's, f64: the
    reconstruction and its gradient with respect to the input to 1e-10; ``NMF`` inherits the keyword; K4 not
    reached."""
    size, opts = (8, 16), dict(rank=1, num_iters=3, init_method="uniform", solver="hals")
    mf_j = ftx.MatrixFactorization(size=size, use_pallas=False, **opts)
    rng = np.random.default_rng(13)
    x, r = rng.random((6, *size)), rng.standard_normal((6, *size))
    variables = jax.tree.map(np.asarray, dict(mf_j.init(jax.random.key(0), jnp.zeros((1, *size)))))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        out_j, vjp = jax.vjp(lambda a: mf_j.apply(v64, a), jnp.asarray(x))
        dx_j = np.asarray(vjp(jnp.asarray(r))[0])
    mf_t = ftt.MatrixFactorization(size, use_pallas=False, **opts).double()
    init = variables["buffers"]["initializer"]
    mf_t.load_state_dict({"init.u0": torch.tensor(init["u0"], dtype=torch.float64),
                          "init.v0": torch.tensor(init["v0"], dtype=torch.float64)})
    assert not mf_t.supports() and ftt.MatrixFactorization(size, **opts).supports()
    assert ftt.NMF(size, use_pallas=False).use_pallas is False
    _no_kernel_routes(monkeypatch)
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = mf_t(xt)
    _close64(out_t, np.asarray(out_j), np.abs(np.asarray(out_j)).max())
    out_t.backward(torch.from_numpy(r))
    _close64(xt.grad, dx_j, np.abs(dx_j).max())


# name -> (spatial size, reshape options, factorizer options, factorize_options): the reasons the port can reach
EXPLAIN_CASES = {
    "k1": ((8, 8, 8), {}, {}, {}),
    "rank2": ((8, 8, 8), {}, {"rank": 2}, {}),
    "cd": ((8, 8, 8), {}, {"solver": "cd"}, {}),
    "svd-init": ((8, 8, 8), {}, {"init_method": "svd"}, {}),
    "2d": ((8, 8), {}, {}, {}),
    "non-cubic": ((8, 8, 8), {"patch_size": (4, 4, 2)}, {}, {}),
    "use_windowed-false": ((8, 8, 8), {}, {}, {"use_windowed": False}),
    "use_pallas-false": ((8, 8, 8), {}, {}, {"use_pallas": False}),
}


@pytest.mark.parametrize("case", list(EXPLAIN_CASES))
def test_explain_logs_jax_reasons(case, caplog):
    """Why a mixer is off K1, in JAX's words: the port's ``fallback_reason`` equals JAX's ``_fused_fallback_reason``
    (asked with ``use_windowed: True``, so that its TPU line does not decide).  Logged at INFO once per reason over
    two forwards, an explicit opt-out not at all; under ``explain: True`` every forward, with the same outputs bit for
    bit; a K1 mixer logs nothing."""
    from factorizer_tpu_torch.models import factorizer as port_factorizer

    spatial, reshape_opts, opts, options = EXPLAIN_CASES[case]
    reshape = {**SW, **reshape_opts}
    m_j = ftx.FactMixer(8, 8, spatial, reshape=(ftx.SWMatricize, reshape), factorize_options={"use_windowed": True,
                                                                                             **options},
                        **_options(ftx, opts))
    reason, _ = m_j.init_with_output(jax.random.key(0), jnp.zeros((2, *spatial, 8)),
                                     method=lambda m, out: m._fused_fallback_reason(out))
    port = {explain: ftt.FactMixer(8, 8, spatial, reshape=(ftt.SWMatricize, reshape), factorize_kwargs=_options(ftt, opts),
                                   factorize_options={**options, "explain": explain})
            for explain in (False, True)}
    port[True].load_state_dict(port[False].state_dict())
    assert port[False].fallback_reason == port[True].fallback_reason == reason
    x = torch.from_numpy(np.random.default_rng(14).random((2, *spatial, 8)))
    logged = {}
    for explain, m in port.items():
        port_factorizer._LOGGED_FALLBACKS.discard(reason)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=port_factorizer.logger.name), torch.no_grad():
            outs = [m(x) for _ in range(2)]
        logged[explain] = [rec.args[-1] for rec in caplog.records if rec.name == port_factorizer.logger.name]
        assert torch.equal(outs[0], outs[1])
        port[explain] = outs[0]
    assert torch.equal(port[False], port[True])
    explicit = bool(options)
    assert logged[False] == ([] if reason is None or explicit else [reason])
    assert logged[True] == ([] if reason is None else [reason, reason])
