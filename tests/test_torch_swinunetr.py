"""Port parity for the transformer baselines: ``SwinUNETR`` (window attention, Swin blocks, patch merging) and
``UNETR``.

Each JAX module and its port get the same weights through the bridge and the
same inputs, made with numpy from a seed (``tests/torch_baseline_cases.py``):
float64 outputs and every parameter gradient to 1e-10 of the largest entry,
float32 outputs to 1e-4 and bfloat16 ones to 2e-2 of the largest output.  The
Swin blocks run on stages the window does not divide (padded after ``norm1``,
the pad unmasked), with and without the shift, and on a stage smaller than the
window (clamped, no shift); a reduced SwinUNETR V2 at window 3 reaches all
three in one network.  Also: the window helpers against JAX's, the relative
position and positional embedding tables' initialisers, and the parameter
counts at ``swinunetr_isles22``'s configuration and UNETR's canonical one.
Everything runs on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu.models import swinunetr as jax_swin

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.models import swinunetr as port_swin
from factorizer_tpu_torch.utils.weights import flax_state_dict
from torch_baseline_cases import CPU, JAX_DTYPES, PORT_DTYPES, check_bfloat16, check_float32, check_float64, check_param_count

torch.set_num_threads(1)

SWIN_REDUCED = dict(in_channels=2, out_channels=3, img_size=(32, 32, 32), feature_size=12, depths=(1, 1, 1, 1),
                    num_heads=(2, 2, 2, 2), window_size=4)
# V2, window 3 at 32^3: stages of 16^3 (padded to 18^3, shifted), 8^3 (9^3), 4^3 (6^3) and 2^3 (clamped, no shift).
SWIN_V2 = dict(SWIN_REDUCED, depths=(2, 2, 2, 2), window_size=3, use_v2=True)
UNETR_REDUCED = dict(in_channels=2, out_channels=3, img_size=(32, 32, 32), feature_size=8, hidden_size=64, mlp_dim=128,
                     num_heads=4, num_layers=3, patch_size=16)


def _block(heads, window, shift, dims):
    return (lambda dt: jax_swin.SwinBlock(8, heads, window, shift, dtype=JAX_DTYPES[dt]),
            lambda dt: ftt.models.SwinBlock(8, heads, window, shift, dims, dtype=PORT_DTYPES[dt], **CPU))


def _net(cls, cfg):
    return (lambda dt: getattr(ftx, cls)(**cfg, dtype=JAX_DTYPES[dt]),
            lambda dt: getattr(ftt, cls)(**cfg, dtype=PORT_DTYPES[dt], **CPU))


# name -> (JAX module, port module, input shape, train, takes a dtype)
CASES = {
    "swinblock_padded_shifted": (*_block(2, (4, 4, 4), (2, 2, 2), (6, 7, 5)), (1, 6, 7, 5, 8), False, True),
    "swinblock_padded": (*_block(2, (4, 4, 4), (0, 0, 0), (6, 7, 5)), (2, 6, 7, 5, 8), False, True),
    "swinblock_clamped": (*_block(4, (7, 7, 7), (3, 3, 3), (4, 4, 4)), (1, 4, 4, 4, 8), False, True),
    "patchmerging": (lambda dt: jax_swin.PatchMerging(6, dtype=JAX_DTYPES[dt]),
                     lambda dt: ftt.models.PatchMerging(6, dtype=PORT_DTYPES[dt], **CPU), (1, 4, 6, 8, 6), False, True),
    "swinunetr": (*_net("SwinUNETR", SWIN_REDUCED), (1, 2, 32, 32, 32), False, True),
    "swinunetr_v2": (*_net("SwinUNETR", SWIN_V2), (1, 2, 32, 32, 32), False, True),
    "unetr": (*_net("UNETR", UNETR_REDUCED), (1, 2, 32, 32, 32), False, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_output_and_gradients_match_jax_f64(name):
    check_float64(CASES[name])


@pytest.mark.parametrize("name", list(CASES))
def test_float32_output_matches_jax(name):
    check_float32(CASES[name])


@pytest.mark.parametrize("name", list(CASES))
def test_bfloat16_output_matches_jax(name):
    check_bfloat16(CASES[name])


@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "masked"])
def test_window_attention_matches_jax_f64(shifted):
    """``WindowAttention`` on windows of a (4, 8, 6) volume in windows of (2, 4, 3), with the shifted-window mask or
    without: the output and every parameter gradient against JAX in float64, to 1e-10 of the largest entry."""
    window, dims = (2, 4, 3), (4, 8, 6)
    n_windows = math.prod(d // w for d, w in zip(dims, window))
    x = np.random.default_rng(4).standard_normal((2 * n_windows, math.prod(window), 12))
    mask_j = jax_swin._shift_attention_mask(dims, window, (1, 2, 1)) if shifted else None
    attn_j = jax_swin.WindowAttention(12, 3, window)
    variables = jax.tree.map(np.asarray, dict(jax.jit(attn_j.init)(jax.random.key(0), jnp.asarray(x, jnp.float32), mask_j)))
    r = np.random.default_rng(5).standard_normal(x.shape)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])

        def loss(p):
            return jnp.sum(attn_j.apply({"params": p}, jnp.asarray(x), mask_j) * r)

        want = np.asarray(attn_j.apply({"params": params}, jnp.asarray(x), mask_j))
        grads = jax.tree.map(np.asarray, jax.grad(loss)(params))
    attn_t = ftt.load_flax_variables(ftt.models.WindowAttention(12, 3, window, **CPU), variables).double()
    mask_t = port_swin._shift_attention_mask(dims, window, (1, 2, 1)) if shifted else None
    out = attn_t(torch.from_numpy(x), mask_t)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())
    (out * torch.from_numpy(r)).sum().backward()
    for key, g in flax_state_dict(attn_t, {"params": grads}).items():
        got = dict(attn_t.named_parameters())[key].grad.numpy()
        np.testing.assert_allclose(got, g.numpy(), rtol=0, atol=1e-10 * np.abs(g.numpy()).max(), err_msg=key)


def test_window_helpers_equal_jax():
    """``_window_partition`` / ``_window_reverse``, ``_relative_position_index`` and ``_shift_attention_mask`` give
    the JAX helpers' values."""
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 6, 5)).astype(np.float32)
    for window in ((4, 4, 2), (8, 3, 6)):
        parts = port_swin._window_partition(torch.from_numpy(x), window)
        np.testing.assert_array_equal(parts.numpy(), np.asarray(jax_swin._window_partition(jnp.asarray(x), window)))
        np.testing.assert_array_equal(port_swin._window_reverse(parts, window, x.shape[1:4]).numpy(), x)
    for window in ((7, 7, 7), (4, 3, 2)):
        np.testing.assert_array_equal(port_swin._relative_position_index(window), jax_swin._relative_position_index(window))
    for dims, window, shift in (((8, 8, 8), (4, 4, 4), (2, 2, 2)), ((12, 8, 6), (4, 4, 3), (2, 2, 1)),
                                ((21, 14, 7), (7, 7, 7), (3, 3, 0))):
        got = port_swin._shift_attention_mask(dims, window, shift)
        want = np.asarray(jax_swin._shift_attention_mask(dims, window, shift))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_window_helpers_equal_jax():
    """``_window_partition`` / ``_window_reverse``, ``_relative_position_index`` and ``_shift_attention_mask`` give
    the JAX helpers' values."""
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 6, 5)).astype(np.float32)
    for window in ((4, 4, 2), (8, 3, 6)):
        parts = port_swin._window_partition(torch.from_numpy(x), window)
        np.testing.assert_array_equal(parts.numpy(), np.asarray(jax_swin._window_partition(jnp.asarray(x), window)))
        np.testing.assert_array_equal(port_swin._window_reverse(parts, window, x.shape[1:4]).numpy(), x)
    for window in ((7, 7, 7), (4, 3, 2)):
        np.testing.assert_array_equal(port_swin._relative_position_index(window), jax_swin._relative_position_index(window))
    for dims, window, shift in (((8, 8, 8), (4, 4, 4), (2, 2, 2)), ((12, 8, 6), (4, 4, 3), (2, 2, 1)),
                                ((21, 14, 7), (7, 7, 7), (3, 3, 0))):
        got = port_swin._shift_attention_mask(dims, window, shift)
        want = np.asarray(jax_swin._shift_attention_mask(dims, window, shift))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_block_of_another_size_raises():
    """A Swin block is built for its stage's size (the window clamps to it): another size raises."""
    block = ftt.models.SwinBlock(8, 2, (4, 4, 4), (2, 2, 2), (6, 7, 5), **CPU)
    with pytest.raises(ValueError, match="built for a stage of"):
        block(torch.zeros(1, 8, 8, 8, 8))


def test_tables_follow_the_jax_initialisers():
    """The relative-position table and UNETR's positional embedding: flax's ``truncated_normal(0.02)`` (a normal of
    deviation 0.02 truncated at two deviations), from the generator given; the table is ``(prod(2w-1), heads)``."""
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    table = ftt.models.WindowAttention(48, 3, (7, 7, 7), generator=gen(), **CPU).rel_pos_bias.detach()
    assert table.shape == (13**3, 3) and table.abs().max().item() <= 0.04 and abs(table.std().item() - 0.0176) < 0.001
    again = ftt.models.WindowAttention(48, 3, (7, 7, 7), generator=gen(), **CPU).rel_pos_bias
    assert torch.equal(table, again.detach())
    unetr = ftt.UNETR(**UNETR_REDUCED, generator=gen(), **CPU)
    assert unetr.pos_embed.shape == (1, 8, 64) and unetr.pos_embed.abs().max().item() <= 0.04


SWIN_ISLES = dict(img_size=[64, 64, 64], in_channels=2, out_channels=1, feature_size=24, window_size=7)
COUNTS = {
    "swinunetr_isles22": ("SwinUNETR", dict(SWIN_ISLES, use_v2=False), (1, 2, 64, 64, 64)),
    "swinunetr_v2": ("SwinUNETR", dict(SWIN_ISLES, use_v2=True), (1, 2, 64, 64, 64)),
    "unetr_canonical": ("UNETR", dict(in_channels=2, out_channels=1, img_size=(128, 128, 128), feature_size=16),
                        (1, 2, 128, 128, 128)),
}


@pytest.mark.parametrize("name", list(COUNTS))
def test_parameter_count_equals_jax(name):
    """The port's parameter count equals ``jax.eval_shape``'s: ``swinunetr_isles22``'s ``network_def``, its V2, and
    UNETR's canonical configuration."""
    cls, cfg, shape = COUNTS[name]
    check_param_count(lambda: getattr(ftx, cls)(**cfg), lambda: getattr(ftt, cls)(**cfg, device="meta"), shape)
