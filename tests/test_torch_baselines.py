"""Port parity for the CNN baselines and the conv blocks: ``DynUNet``, ``SegResNet``, ``DoubleConv``, ``BasicBlock``,
``PreActivationBlock``, ``SepConv``, and the layers they need.

Each JAX module and its port get the same weights through the bridge and the
same inputs, made with numpy from a seed (``tests/torch_baseline_cases.py``).
The semantic check is float64 (``model.double()`` against JAX under x64): the
output and every parameter gradient of ``sum(out * r)`` for a random ``r``,
each to 1e-10 of its largest entry (of a thousandth of the model's largest
gradient where that is more: a bias that a norm removes has a gradient of
rounding noise).  float32 outputs agree to 1e-4 and bfloat16 ones (the
modules' ``dtype``) to 2e-2 of the largest output.  Also: the parameter counts
at the bundles' configurations, dropout, grouped and dilated convolutions, the
activation table, the initial weights' distributions, the late-built
``SegResNet`` and the default device.  The transformers (``SwinUNETR``,
``UNETR``) are in ``tests/test_torch_swinunetr.py``.  Everything runs on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu.layers import basic as jax_basic
from factorizer_tpu.layers import conv_blocks as jax_blocks
from factorizer_tpu.models import dynunet as jax_dynunet
from factorizer_tpu.models import segresnet as jax_segresnet

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.layers import basic as port_basic
from factorizer_tpu_torch.utils.helpers import materialize
from torch_baseline_cases import (
    CPU, JAX_DTYPES, PORT_DTYPES, check_bfloat16, check_float32, check_float64, check_param_count, init_variables,
)

torch.set_num_threads(1)

SEGRES_3D = dict(in_channels=2, out_channels=3, init_filters=8, blocks_down=(1, 2, 2), blocks_up=(1, 1))
SEGRES_2D = dict(in_channels=3, out_channels=1, init_filters=8, blocks_down=(1, 1, 1), blocks_up=(1, 1))
DYN_3D = dict(in_channels=2, out_channels=3, kernel_size=(3, 3, 3), strides=(1, 2, 2), filters=(8, 16, 32))
DYN_ANISO = dict(in_channels=2, out_channels=3, kernel_size=[[1, 3, 3], [3, 3, 3], [3, 3, 1]],
                 strides=[[1, 1, 1], [1, 2, 2], [2, 2, 1]], filters=(8, 16, 24))
DYN_DS = dict(in_channels=2, out_channels=3, kernel_size=(3, 3, 3, 3), strides=(1, 2, 2, 2), filters=(8, 16, 16, 32),
              deep_supervision=True, deep_supr_num=2)


def _seg(mode, cfg):
    return (lambda dt: ftx.SegResNet(**cfg, upsample_mode=mode, dtype=JAX_DTYPES[dt]),
            lambda dt: ftt.SegResNet(**cfg, upsample_mode=mode, dtype=PORT_DTYPES[dt], **CPU))


def _dyn(cfg):
    return (lambda dt: ftx.DynUNet(**cfg, dtype=JAX_DTYPES[dt]), lambda dt: ftt.DynUNet(**cfg, dtype=PORT_DTYPES[dt], **CPU))


# name -> (JAX module, port module, input shape, train, takes a dtype); ``dt`` is the dtype's name.
CASES = {
    "segresblock": (lambda dt: jax_segresnet.SegResBlock(8, dtype=JAX_DTYPES[dt]),
                    lambda dt: ftt.SegResBlock(8, dtype=PORT_DTYPES[dt], **CPU), (1, 8, 8, 6, 8), False, True),
    "segresnet_3d_deconv": (*_seg("deconv", SEGRES_3D), (1, 2, 16, 16, 16), False, True),
    "segresnet_3d_linear": (*_seg("linear", SEGRES_3D), (1, 2, 16, 16, 16), False, True),
    "segresnet_2d_deconv": (*_seg("deconv", SEGRES_2D), (1, 3, 32, 32), False, True),
    "segresnet_2d_linear": (*_seg("linear", SEGRES_2D), (2, 3, 32, 32), False, True),
    "dynunetblock": (lambda dt: jax_dynunet.DynUNetBlock(4, 8, kernel_size=(3, 1, 3), stride=(2, 1, 2), dtype=JAX_DTYPES[dt]),
                     lambda dt: ftt.DynUNetBlock(4, 8, kernel_size=(3, 1, 3), stride=(2, 1, 2), dtype=PORT_DTYPES[dt], **CPU),
                     (1, 8, 6, 8, 4), False, True),
    "dynunet_3d": (*_dyn(DYN_3D), (1, 2, 16, 16, 16), False, True),
    "dynunet_2d": (*_dyn(dict(DYN_3D, in_channels=3, out_channels=1, spatial_dims=2)), (1, 3, 32, 32), False, True),
    "dynunet_anisotropic": (*_dyn(DYN_ANISO), (1, 2, 8, 16, 12), False, True),
    "dynunet_deep_supervision": (*_dyn(DYN_DS), (1, 2, 16, 16, 16), True, True),
    "doubleconv": (lambda dt: jax_blocks.DoubleConv(8, 16, stride=2),
                   lambda dt: ftt.DoubleConv(8, 16, stride=2, **CPU), (1, 8, 8, 6, 8), False, False),
    "basicblock_projection": (lambda dt: jax_blocks.BasicBlock(8, 16, stride=2),
                              lambda dt: ftt.BasicBlock(8, 16, stride=2, **CPU), (1, 8, 8, 6, 8), False, False),
    "basicblock_identity": (lambda dt: jax_blocks.BasicBlock(16, 16, mid_channels=8),
                            lambda dt: ftt.BasicBlock(16, 16, mid_channels=8, **CPU), (1, 6, 8, 4, 16), False, False),
    "preactivationblock": (lambda dt: jax_blocks.PreActivationBlock(8, 16, stride=(1, 2, 2), act="gelu"),
                           lambda dt: ftt.PreActivationBlock(8, 16, stride=(1, 2, 2), act="gelu", **CPU),
                           (1, 4, 8, 6, 8), False, False),
    "sepconv_2d": (lambda dt: jax_blocks.SepConv(6, 8, kernel_size=3, padding=2, dilation=2),
                   lambda dt: ftt.SepConv(6, 8, kernel_size=3, padding=2, dilation=2, spatial_dims=2, **CPU),
                   (1, 9, 10, 6), False, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_output_and_gradients_match_jax_f64(name):
    """float64: the output (DynUNet's deep-supervision list in training mode) and every parameter gradient."""
    check_float64(CASES[name])


@pytest.mark.parametrize("name", list(CASES))
def test_float32_output_matches_jax(name):
    check_float32(CASES[name])


@pytest.mark.parametrize("name", [name for name, case in CASES.items() if case[4]])
def test_bfloat16_output_matches_jax(name):
    check_bfloat16(CASES[name])


BRATS, ISLES, FIVES = dict(in_channels=4, out_channels=3), dict(in_channels=2, out_channels=1), dict(in_channels=3, out_channels=1)
NNUNET = dict(kernel_size=[3] * 5, strides=[1, 2, 2, 2, 2], filters=[32, 64, 128, 256, 512])
SEGRESNET = dict(init_filters=32, blocks_down=[1, 2, 2, 4], blocks_up=[1, 1, 1], upsample_mode="linear")
# name -> (class, configuration, the input shape eval_shape sees): the bundles' network_def and the defaults.
BUNDLE_CONFIGS = {
    "nnunet_brats23": ("DynUNet", dict(**BRATS, spatial_dims=3, **NNUNET), (1, 4, 32, 32, 32)),
    "nnunet_isles22": ("DynUNet", dict(**ISLES, spatial_dims=3, **NNUNET), (1, 2, 32, 32, 32)),
    "nnunet_fives": ("DynUNet", dict(**FIVES, spatial_dims=2, **NNUNET), (1, 3, 32, 32)),
    "dynunet_defaults": ("DynUNet", dict(ISLES), (1, 2, 32, 32, 32)),
    "segresnet_brats23": ("SegResNet", dict(**BRATS, **SEGRESNET), (1, 4, 32, 32, 32)),
    "segresnet_isles22": ("SegResNet", dict(**ISLES, **SEGRESNET), (1, 2, 32, 32, 32)),
    "segresnet_fives": ("SegResNet", dict(**FIVES, **SEGRESNET), (1, 3, 32, 32)),
    "segresnet_defaults": ("SegResNet", dict(ISLES), (1, 2, 32, 32, 32)),
}


@pytest.mark.parametrize("name", list(BUNDLE_CONFIGS))
def test_parameter_count_equals_jax(name):
    """The port's parameter count equals ``jax.eval_shape``'s at the bundles' ``network_def`` and the defaults."""
    cls, cfg, shape = BUNDLE_CONFIGS[name]
    check_param_count(lambda: getattr(ftx, cls)(**cfg), lambda: getattr(ftt, cls)(**cfg, device="meta"), shape)


def test_dropout_identity_and_keep_rate():
    """``Dropout``: the identity at ``p = 0`` and in eval mode; in training mode it keeps ~``1 - p`` and scales
    the kept by ``1 / (1 - p)``, as flax's."""
    x = torch.ones(200_000)
    assert ftt.Dropout().p == 0.0 and torch.equal(ftt.Dropout().train()(x), x)
    drop = ftt.Dropout(0.25)
    assert torch.equal(drop.eval()(x), x)
    torch.manual_seed(0)
    y = drop.train()(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))


@pytest.mark.parametrize("dims,groups,dilation", [(3, 2, 2), (2, 4, (1, 3)), (3, 1, (2, 1, 1))])
def test_conv_groups_and_dilation_match_jax(dims, groups, dilation):
    """``Conv`` with ``groups`` and ``dilation``: the JAX layer's output in float64, and the fan-in of the uniform
    bound (``in / groups * prod(k)``)."""
    shape = (2, *([9] * dims), 8)
    x = np.random.default_rng(0).standard_normal(shape)
    conv_j = jax_basic.Conv(8, 12, kernel_size=3, padding=2, stride=1, groups=groups, dilation=dilation)
    variables = init_variables(conv_j, x.astype(np.float32))
    conv_t = ftt.Conv(8, 12, kernel_size=3, padding=2, groups=groups, dilation=dilation, spatial_dims=dims, **CPU)
    assert tuple(conv_t.weight.shape) == (12, 8 // groups, *([3] * dims))
    assert conv_t.weight.abs().max().item() <= 1 / math.sqrt(8 // groups * 3**dims)
    ftt.load_flax_variables(conv_t.double(), variables)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        want = np.asarray(conv_j.apply({"params": params}, jnp.asarray(x)))
    got = conv_t(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(jax_basic.ACTIVATIONS))
def test_activation_table_matches_jax(name):
    """Each name of the JAX ``ACTIVATIONS`` table is in the port's and computes the same function in float64."""
    x = np.linspace(-6, 6, 1001)
    with jax.enable_x64(True):
        want = np.asarray(jax_basic.ACTIVATIONS[name](jnp.asarray(x)))
    got = port_basic.ACTIVATIONS[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


def test_resolve_activation_forms():
    """A name, None (identity), an elementwise callable, or a factory class, as the JAX ``resolve_activation``."""
    x = torch.linspace(-2, 2, 9)
    assert port_basic.resolve_activation("leaky_relu") is port_basic.ACTIVATIONS["leaky_relu"]
    assert torch.equal(port_basic.resolve_activation(None)(x), x)
    assert port_basic.resolve_activation(torch.tanh) is torch.tanh
    assert torch.equal(port_basic.resolve_activation(torch.nn.ReLU)(x), torch.relu(x))
    with pytest.raises(TypeError):
        port_basic.resolve_activation(3)


def test_layer_norm_eps():
    """The port's ``LayerNorm`` takes ``eps`` (1e-5 by default, torch's); ``FlaxLayerNorm`` is flax's bare
    ``nn.LayerNorm`` at 1e-6, the JAX transformers' value, and its parameters are its own."""
    assert ftt.LayerNorm(8, **CPU).eps == 1e-5 and ftt.LayerNorm(8, eps=1e-6, **CPU).norm.eps == 1e-6
    bare = ftt.layers.FlaxLayerNorm(8, **CPU)
    assert bare.eps == 1e-6 and sorted(bare.state_dict()) == ["bias", "weight"]
    x = torch.randn(3, 8, dtype=torch.float64) * 1e-3
    want = (x - x.mean(-1, keepdim=True)) / torch.sqrt(x.var(-1, unbiased=False, keepdim=True) + 1e-6)
    torch.testing.assert_close(bare.double()(x), want, rtol=1e-12, atol=1e-12)


def test_initial_weights_follow_the_jax_initialisers():
    """Dense (flax's lecun-normal: a normal truncated at 2 deviations, of variance 1 / fan_in; zero bias), the bare
    norms (ones, zeros) and Conv (the torch-like uniform bound 1 / sqrt(fan_in)), drawn from the generator given."""
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    dense = ftt.Dense(400, 300, generator=gen(), **CPU)
    w = dense.weight.detach()
    assert abs(w.std().item() * math.sqrt(400) - 1.0) < 0.02 and w.abs().max().item() <= 2 / math.sqrt(400) / 0.8796
    assert torch.equal(dense.bias, torch.zeros(300))
    assert torch.equal(dense.weight, ftt.Dense(400, 300, generator=gen(), **CPU).weight)
    for norm in (ftt.layers.FlaxLayerNorm(6, **CPU), ftt.layers.FlaxGroupNorm(2, 6, **CPU)):
        assert torch.equal(norm.weight, torch.ones(6)) and torch.equal(norm.bias, torch.zeros(6))
    conv = ftt.Conv(2, 16, kernel_size=16, stride=16, generator=gen(), **CPU).weight.detach()
    bound = 1 / math.sqrt(2 * 16**3)
    assert conv.abs().max().item() <= bound and conv.abs().max().item() > 0.95 * bound


def test_segresnet_builds_at_its_first_input_or_materialize():
    """``SegResNet`` takes its rank from its first input, as the JAX model does at ``init``: before that it holds no
    parameter and the entry points that need weights raise; ``materialize(2)`` builds the same 2-D network from the
    same generator as a forward of a 2-D batch does (also one under inference mode, whose weights still train);
    another rank afterwards raises."""
    make = lambda: ftt.SegResNet(**SEGRES_2D, generator=torch.Generator().manual_seed(5), **CPU)  # noqa: E731
    lazy = make()
    assert not lazy.materialized and list(lazy.parameters()) == []
    with pytest.raises(RuntimeError, match="materialize"):
        ftt.create_train_state(lazy, device="cpu", lr=0.0)
    with pytest.raises(RuntimeError, match="materialize"):
        ftt.load_flax_variables(lazy, {"params": {}})
    with torch.inference_mode():
        out = lazy(torch.zeros(1, 3, 16, 16))
    assert lazy.spatial_dims == 2 and lazy.stem.weight.ndim == 4 and out.shape == (1, 1, 16, 16)
    assert not lazy.stem.weight.is_inference()  # built under inference mode, the weights still train
    built = materialize(make(), 2)
    assert built.state_dict().keys() == lazy.state_dict().keys()
    for key, value in built.state_dict().items():
        assert torch.equal(value, lazy.state_dict()[key]), key
    with pytest.raises(ValueError, match="2-D"):
        built.materialize(3)
    torch.manual_seed(0)
    a = materialize(ftt.SegResNet(**SEGRES_2D, **CPU), 2)
    torch.manual_seed(0)
    b = materialize(ftt.SegResNet(**SEGRES_2D, **CPU), 2)
    assert torch.equal(a.stem.weight, b.stem.weight)  # the default generator's seed fixes the weights


@pytest.mark.parametrize("cls,args", [(ftt.DynUNet, (2, 1)), (ftt.SegResNet, (2, 1)), (ftt.SwinUNETR, (2, 1)),
                                      (ftt.UNETR, (2, 1)), (ftt.DoubleConv, (4, 8)), (ftt.SepConv, (4,))],
                         ids=["DynUNet", "SegResNet", "SwinUNETR", "UNETR", "DoubleConv", "SepConv"])
def test_default_device_is_the_card(cls, args, monkeypatch):
    """``device=None`` is the card: where there is none, building raises and names ``device='cpu'``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(*args)
