"""Port parity for the whole model: the weight bridge and a reduced Factorizer forward.

The JAX model runs its CPU paths (SWMatricize -> NMF mixers, unfused MLP); the
port runs the kernels' plain versions, which is what its wrappers do for CPU
tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu.utils.torch_import import convert_state_dict

import factorizer_tpu_torch as ftt

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


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield ".".join((*prefix, k)), np.asarray(v)


@pytest.fixture(scope="module")
def models():
    """A JAX Factorizer with its variables, and a port Factorizer loaded from them."""
    jax_model = ftx.Factorizer(**CONFIG, reshape=(ftx.SWMatricize, SW))
    variables = jax.jit(jax_model.init)(jax.random.key(0), jnp.zeros((1, 4, *SP)))
    variables = jax.tree.map(np.asarray, dict(variables))
    port = ftt.Factorizer(**CONFIG, reshape=(ftt.SWMatricize, SW), generator=torch.Generator().manual_seed(1))
    ftt.load_flax_variables(port, variables)
    return jax_model, variables, port.eval()


def test_bridge_reproduces_jax_variables(models):
    """convert_state_dict(port.state_dict()) equals the JAX variables leaf for leaf (exactly)."""
    _, variables, port = models
    converted = dict(_leaves(convert_state_dict(port.state_dict())))
    expected = dict(_leaves(variables))
    assert converted.keys() == expected.keys()
    for key, value in expected.items():
        np.testing.assert_array_equal(converted[key], value, err_msg=key)


def test_bridge_round_trip(models):
    """load_flax_variables(convert_state_dict(sd)) restores every entry of sd exactly."""
    _, _, port = models
    other = ftt.Factorizer(**CONFIG, reshape=(ftt.SWMatricize, SW), generator=torch.Generator().manual_seed(2))
    ftt.load_flax_variables(other, convert_state_dict(port.state_dict()))
    sd, sd2 = port.state_dict(), other.state_dict()
    assert sd.keys() == sd2.keys()
    for key in sd:
        assert torch.equal(sd[key], sd2[key]), key


def test_reduced_factorizer_forward_matches_jax(models):
    """f32 forward against model.apply: the same weights give the same logits to 1e-4 (rtol 1e-4)."""
    jax_model, variables, port = models
    x = np.random.default_rng(0).standard_normal((2, 4, *SP)).astype(np.float32)
    y_j = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        y_t = port(torch.from_numpy(x)).numpy()
    assert y_t.shape == (2, 3, *SP)
    np.testing.assert_allclose(y_t, y_j, rtol=1e-4, atol=1e-4)


def test_reduced_factorizer_bf16_forward_matches_jax(models):
    """bf16 compute (the bundle's amp) against the JAX model in bf16: within 5e-2 (rtol 5e-2).

    Both keep f32 parameters and an f32 head; the port's fused MLP tail works
    in f32 where the JAX chain rounds to bf16 after each layer.
    """
    jax_model, variables, _ = models
    port = ftt.Factorizer(**CONFIG, reshape=(ftt.SWMatricize, SW), dtype=torch.bfloat16)
    ftt.load_flax_variables(port, variables)
    jax_bf16 = ftx.Factorizer(**CONFIG, reshape=(ftx.SWMatricize, SW), dtype=jnp.bfloat16)
    x = np.random.default_rng(1).standard_normal((1, 4, *SP)).astype(np.float32)
    y_j = np.asarray(jax.jit(jax_bf16.apply)(variables, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        y_t = port(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=5e-2, atol=5e-2)


MIXER_CASES = {
    # reshape spec, rank: which FactMixer path runs
    "matricize_plain_path": ("Matricize", {"num_heads": 2, "grid_size": (1, 2, 1)}, None),  # non-cubic patch
    "swmatricize_kernel_path": ("SWMatricize", SW, 1),
    "swmatricize_rank2_plain_path": ("SWMatricize", SW, 2),
}


@pytest.mark.parametrize("case", list(MIXER_CASES))
def test_factmixer_matches_jax(case):
    """Both FactMixer paths (K1's plain version, and fold -> NMF -> unfold) against JAX; f32, 1e-5."""
    cls, kw, rank = MIXER_CASES[case]
    c, sp = 8, (8, 8, 8)
    opts = dict(num_iters=5, init_method="uniform", solver="hals")
    m_j = ftx.FactMixer(c, c, sp, reshape=(getattr(ftx, cls), kw), rank=rank, **opts)
    x = np.random.default_rng(3).standard_normal((2, *sp, c)).astype(np.float32)
    v = jax.tree.map(np.asarray, dict(m_j.init(jax.random.key(0), jnp.asarray(x))))
    m_t = ftt.FactMixer(c, c, sp, reshape=(getattr(ftt, cls), kw), factorize_kwargs=dict(rank=rank, **opts))
    assert (m_t.windowed is not None) == (case == "swmatricize_kernel_path")
    p = v["params"]
    init = v["buffers"]["factorize_op"]["initializer"]
    m_t.load_state_dict({
        "in_proj.linear.weight": torch.tensor(p["in_proj"]["linear"]["kernel"].T),
        "out_proj.linear.weight": torch.tensor(p["out_proj"]["linear"]["kernel"].T),
        "out_proj.linear.bias": torch.tensor(p["out_proj"]["linear"]["bias"]),
        "factorize.init.u0": torch.tensor(init["u0"]),
        "factorize.init.v0": torch.tensor(init["v0"]),
    })
    y_j = np.asarray(m_j.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        y_t = m_t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-5)


def test_bundle_network_names_match_jax_at_full_width():
    """brats23_network's state dict converts onto the JAX bundle network's variable tree (shapes)."""
    port = ftt.brats23_network(device="cpu", generator=torch.Generator().manual_seed(0))
    jax_model = ftx.Factorizer(
        in_channels=4, out_channels=3, spatial_size=(128, 128, 128),
        encoder_depth=(1, 1, 1, 1, 1), encoder_width=(32, 64, 128, 256, 512), strides=(1, 2, 2, 2, 2),
        decoder_depth=(1, 1, 1, 1), mlp_ratio=4, act="relu", rank=1, num_iters=5, init_method="uniform",
        solver="hals", reshape=(ftx.SWMatricize, {"head_dim": 8, "patch_size": 8, "shifts": [None, 2, 4, 6]}),
    )
    shapes = jax.eval_shape(jax_model.init, jax.random.key(0), jax.ShapeDtypeStruct((1, 4, 128, 128, 128), jnp.float32))
    expected = {k: tuple(v.shape) for k, v in _leaves(jax.tree.map(lambda s: np.empty(s.shape, np.int8), dict(shapes)))}
    converted = {k: v.shape for k, v in _leaves(convert_state_dict(port.state_dict()))}
    assert converted == expected
