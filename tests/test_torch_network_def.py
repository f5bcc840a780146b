"""The port's models build from the bundles' ``network_def`` (``norm``, ``factorize``, ``remat``), as the JAX models do.

Each of the five Factorizer and Deconver bundles' ``configs/train.yaml`` is
read unedited and its ``network_def`` resolved key by key by the port's
``ConfigParser`` (``$ftx.<Name>`` -> the port's class, ``@key`` -> the file's
value, ``dtype`` -> None as ``amp: false`` gives).  Then: the full-width models equal the zoo factories';
``remat=True`` gives the step of ``remat=False``; a reduced model with
``remat=True``, and one with ``norm=InstanceNorm``, against the JAX model in f64.
Everything runs on the CPU, where the kernels' wrappers take their plain versions.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu.train import losses as jax_losses
from factorizer_tpu.utils.torch_import import convert_state_dict

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.config import ConfigParser, load_config_files
from factorizer_tpu_torch.layers import basic as port_basic
from factorizer_tpu_torch.ops.kernels import prenorm_mlp as k2
from factorizer_tpu_torch.train import trainer as port_trainer

torch.set_num_threads(1)

ZOO = Path(__file__).resolve().parents[1] / "zoo"
BUNDLES = {
    "factorizer_brats23": ftt.brats23_network,
    "factorizer_isles22": ftt.factorizer_isles22_network,
    "deconver_brats23": ftt.deconver_brats23_network,
    "deconver_isles22": ftt.deconver_isles22_network,
    "deconver_fives": ftt.deconver_fives_network,
}


def network_def(bundle: str) -> tuple[type, dict]:
    """``(model class, keyword arguments)`` of the bundle's unedited ``network_def``, f32 (``amp: false``), each
    argument resolved by the port's ``ConfigParser``."""
    config = load_config_files([ZOO / bundle / "configs" / "train.yaml"])
    assert config["amp"] is False and config["network_def"]["dtype"] == "$jnp.bfloat16 if @amp else None"
    parser = ConfigParser(config)
    keys = [k for k in config["network_def"] if k != "_target_"]
    kwargs = {k: parser[f"network_def#{k}"] for k in keys}
    assert kwargs["dtype"] is None
    return parser.registry[config["network_def"]["_target_"]], kwargs


@pytest.mark.parametrize("bundle", list(BUNDLES))
def test_bundle_network_def_builds_the_factory_model(bundle):
    """``Model(**network_def, device="cpu")`` at full width: the zoo factory's parameters, names and values
    (the same generator seed), and the keys the JAX model is given (``norm``, ``remat``; ``factorize`` for
    the Factorizer) taken as given."""
    cls, kwargs = network_def(bundle)
    assert "norm" in kwargs and kwargs["remat"] is False
    assert (kwargs.get("factorize") is ftt.NMF) == (cls is ftt.Factorizer)
    model = cls(**kwargs, device="cpu", generator=torch.Generator().manual_seed(0))
    factory = BUNDLES[bundle](device="cpu", generator=torch.Generator().manual_seed(0))
    assert type(model) is type(factory)
    sd, want = model.state_dict(), factory.state_dict()
    assert sd.keys() == want.keys()
    assert sum(p.numel() for p in model.parameters()) == sum(p.numel() for p in factory.parameters())
    for key in want:
        assert torch.equal(sd[key], want[key]), key


@pytest.mark.parametrize("bundle", list(BUNDLES))
def test_bundle_factory_passes_remat(bundle):
    """The zoo factory's ``remat=True`` is the bundle's ``remat: true``: every encoder and decoder stage of the
    factory's model recomputes its block."""
    model = BUNDLES[bundle](remat=True, device="cpu")
    stages = [*model.encoder.blocks, *model.decoder.blocks]
    assert len(stages) == 9 and all(stage.remat for stage in stages)


def test_factorizer_refuses_a_factorizer_it_does_not_port():
    """``factorize`` that is no matrix factorizer (``Deconv``: no matrices' ``size``) raises, naming the class."""
    cls, kwargs = network_def("factorizer_brats23")
    with pytest.raises(NotImplementedError, match="Deconv"):
        cls(**{**kwargs, "factorize": ftt.Deconv}, device="cpu")


# Reduced models: three stages, narrow widths.
SP = (16, 16, 16)
FACTORIZER = dict(
    in_channels=4, out_channels=3, spatial_size=SP, encoder_depth=(1, 1, 1), encoder_width=(8, 16, 16),
    strides=(1, 2, 2), decoder_depth=(1, 1), mlp_ratio=4, act="relu", rank=1, num_iters=5, init_method="uniform",
    solver="hals",
)
SW = {"head_dim": 4, "patch_size": 4, "shifts": [None, 1, 2, 3]}
DECONVER = dict(
    in_channels=4, out_channels=3, spatial_dims=3, encoder_depth=(1, 1, 1), encoder_width=(8, 16, 32),
    strides=(1, 2, 2), decoder_depth=(1, 1), act="relu", groups=-1, ratio=1, kernel_size=(3, 3, 3), num_iters=1,
    mlp_ratio=4,
)


def _port_model(name: str, **kwargs) -> torch.nn.Module:
    if name == "factorizer":
        return ftt.Factorizer(**FACTORIZER, reshape=(ftt.SWMatricize, SW), **kwargs)
    return ftt.Deconver(**DECONVER, norm=ftt.InstanceNorm, **kwargs)


def _batch(seed: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, *SP)).astype(dtype)
    y = (rng.random((2, 3, *SP)) > 0.7).astype(dtype)
    return x, y


def _step(model: torch.nn.Module, x: np.ndarray, y: np.ndarray):
    """One train step at lr 0: ``(loss, {name: gradient})``."""
    state = port_trainer.create_train_state(model, device="cpu", lr=0.0)
    state, metrics = port_trainer.make_train_step(state.model)(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    return metrics["loss"], {k: p.grad for k, p in state.model.named_parameters()}


@pytest.mark.parametrize("name", ["factorizer", "deconver"])
def test_remat_gives_the_same_step(name):
    """``remat=True`` against ``remat=False`` from the same weights: the same loss and every gradient leaf, bit
    for bit (the recompute repeats the forward's operations in the same order), while each stage block runs its
    forward twice in a step (once more in the backward) and once under ``no_grad``."""
    x, y = _batch(3)
    plain = _port_model(name, device="cpu", generator=torch.Generator().manual_seed(1))
    remat = _port_model(name, remat=True, device="cpu", generator=torch.Generator().manual_seed(1))
    calls = []
    stages = [*remat.encoder.blocks, *remat.decoder.blocks]
    for i, stage in enumerate(stages):  # a counting forward (checkpoint's recompute runs no forward hooks)
        stage.block.forward = lambda t, i=i, run=stage.block.forward: calls.append(i) or run(t)
    loss, grads = _step(plain, x, y)
    loss_r, grads_r = _step(remat, x, y)
    assert sorted(calls) == sorted(2 * list(range(len(stages))))
    assert torch.equal(loss, loss_r)
    assert grads.keys() == grads_r.keys()
    for key in grads:
        assert torch.equal(grads[key], grads_r[key]), key
    calls.clear()
    with torch.no_grad():
        remat(torch.from_numpy(x))
    assert sorted(calls) == list(range(len(stages)))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield ".".join((*prefix, k)), np.asarray(v)


def _check_step_against_jax(jax_model, port, x, y):
    """The port's f64 train step against ``jax.value_and_grad`` of the JAX model's ``apply`` under x64, from
    the same weights: the loss to 1e-12, every gradient leaf to 1e-10 of its largest entry (f64: the two
    frameworks sum in other orders, nothing else differs)."""
    variables = jax.tree.map(np.asarray, dict(jax.jit(jax_model.init)(jax.random.key(0), jnp.zeros((1, 4, *SP)))))
    ftt.load_flax_variables(port, variables)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        rest = {k: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v) for k, v in variables.items() if k != "params"}

        def compute_loss(p):
            logits = jax_model.apply({"params": p, **rest}, jnp.asarray(x), train=True, rngs={"dropout": jax.random.key(0)})
            return jax_losses.dice_ce_loss(logits, jnp.asarray(y))

        loss_j, grads_j = jax.jit(jax.value_and_grad(compute_loss))(params)
        expected = dict(_leaves(jax.tree.map(np.asarray, grads_j)))
    loss, grads = _step(port.double(), x, y)
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-12)
    as_state = {k: grads.get(k, torch.zeros_like(v)) for k, v in port.state_dict().items()}
    got = dict(_leaves(convert_state_dict(as_state)["params"]))
    assert got.keys() == expected.keys()
    for key, want in expected.items():
        np.testing.assert_allclose(got[key], want, rtol=1e-10, atol=1e-10 * np.abs(want).max(), err_msg=key)


def test_remat_factorizer_step_matches_jax_remat():
    """The reduced Factorizer with ``remat=True`` against the JAX Factorizer with ``remat=True`` (``nn.remat``
    around each stage), f64."""
    jax_model = ftx.Factorizer(**FACTORIZER, reshape=(ftx.SWMatricize, SW), remat=True)
    port = _port_model("factorizer", remat=True, device="cpu")
    _check_step_against_jax(jax_model, port, *_batch(5, np.float64))


def test_instance_norm_factorizer_takes_the_stock_tails_and_matches_jax(monkeypatch):
    """``norm=InstanceNorm``: no block tail reaches K2's wrapper (LayerNorm sends all five there at K2's widths), the
    norms add no parameter, and the f64 step matches the JAX Factorizer with ``norm=InstanceNorm``."""
    calls = []
    monkeypatch.setattr(port_basic, "prenorm_mlp", lambda *a: calls.append(1) or k2(*a))
    x, y = _batch(9, np.float64)
    with torch.no_grad():
        ftt.Factorizer(**{**FACTORIZER, "encoder_width": (32, 32, 32)}, reshape=(ftt.SWMatricize, SW),
                       device="cpu")(torch.from_numpy(x).float())
    assert len(calls) == 5
    calls.clear()
    port = _port_model("factorizer", norm=ftt.InstanceNorm, device="cpu")
    assert not any(".norm1." in k or ".norm2." in k for k in port.state_dict())
    jax_model = ftx.Factorizer(**FACTORIZER, reshape=(ftx.SWMatricize, SW), norm=ftx.InstanceNorm)
    _check_step_against_jax(jax_model, port, x, y)
    assert not calls


def test_kernel_autograd_functions_run_under_checkpoint(monkeypatch):
    """K1's and K2's autograd functions (the card's path) inside ``checkpoint(..., use_reentrant=False)``, as
    ``remat=True`` runs them: each backward reads its saved tensors once, and the recomputed step gives the
    gradients of the step without the checkpoint.  Their launches are swapped for the plain versions, which the
    CPU runs."""
    import importlib

    from torch.utils.checkpoint import checkpoint

    mlp_block = importlib.import_module("factorizer_tpu_torch.ops.kernels.mlp_block")
    windowed_nmf = importlib.import_module("factorizer_tpu_torch.ops.kernels.windowed_nmf")

    monkeypatch.setattr(mlp_block, "_launch_forward", lambda x, p, eps: mlp_block.prenorm_mlp_plain(x, *p.values(), eps))
    monkeypatch.setattr(mlp_block, "prenorm_mlp_backward", mlp_block.prenorm_mlp_backward_plain)
    monkeypatch.setattr(windowed_nmf, "_forward", lambda x, *a: windowed_nmf.windowed_nmf_plain(x, *a))
    monkeypatch.setattr(windowed_nmf, "windowed_nmf_backward", windowed_nmf.windowed_nmf_backward_plain)
    rng = np.random.default_rng(2)
    c, h = 8, 32
    x = torch.tensor(rng.random((1, 8, 8, 8, c)), dtype=torch.float32)
    params = [torch.tensor(rng.standard_normal(shape) * 0.3, dtype=torch.float32, requires_grad=True)
              for shape in ((c,), (c,), (h, c), (h,), (c, h), (c,))]
    u0, v0 = torch.rand(4, 1), torch.rand(64, 1)

    def block(t):
        t = windowed_nmf._WindowedNMF.apply(t, u0, v0, 4, 4, ((0, 0, 0), (1, 1, 1)), "hals", 3, 1e-16, None)
        return mlp_block._PrenormMLP.apply(t, *params, 1e-5)

    grads = []
    for run in (block, lambda t: checkpoint(block, t, use_reentrant=False)):
        leaf = x.clone().requires_grad_(True)
        (run(leaf) ** 2).sum().backward()
        grads.append([leaf.grad, *(p.grad.clone() for p in params)])
        for p in params:
            p.grad = None
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
