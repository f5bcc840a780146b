"""The spatial step on slabs of unequal rows: a volume whose rows the process count does not divide.

JAX's GSPMD pads such a cut (``factorizer_tpu/train/trainer.py`` constrains
the batch's first spatial axis over ``model`` inside ``jit``); the port, one
process per card, cuts it into slabs of unequal rows by one rule
(``parallel.slabs.choose_cut``).  Held here:

* (a) the rule as a pure function: today's equal cut where the count divides
  the rows, the grid of the model's strides otherwise, and empty slabs where
  the count exceeds the rows;
* (b) every family in float64 on 3 gloo processes at rows that 3 does not
  divide, against one process to 1e-10 of the largest magnitude: the
  Factorizer (K5 on unequal slabs, its thin levels gathered around K1, the
  bottleneck gathered by the route), the Deconver with ``update_filter``,
  DynUNet with a deep-supervision head, SegResNet, SwinUNETR and UNETR (a cut
  on a grid of one row).  The eval logits, the step's loss, every gradient and
  the parameters after one AdamW step; the three processes' parameters equal
  bit for bit;
* (c) K5's ring of unequal slabs held in one process against K1's plain
  version on the whole volume, forward and backward;
* (d) 3 slabs of an input of 2 rows (a DynUNet of stride 1 along the cut
  axis, nnU-Net's anisotropic form, with a deep-supervision head): slabs of 1
  / 1 / 0 rows, the whole model gathered, against one process in float64; the
  gathers and cuts of zero rows on their own;
* (e) deep-supervision heads below the cut's grid (the Factorizer, the
  generic UNet and the Deconver with ``num_deep_supr: 4`` on 8 / 4 / 4 rows:
  head 3 reads a level of 2 rows, whose shares are 1 / 1/2 / 1/2), the head's
  whole output on every process, against one process in float64;
* (f) the port's 3-slab step against JAX's own spatial step on 3 of the 8 XLA
  CPU devices, which GSPMD pads: a reduced DynUNet (convolutions, so XLA
  partitions it), and the cases of (d) and (e), loss and every gradient in
  float64.

``count_once`` scales a gathered part's cotangent by ``1 / 3``, exact only to
the last bits; the band 1e-10 holds that.  The workers are module-level
functions run by ``parallel.run_processes``.
"""

import itertools
import operator

import numpy as np
import pytest
import torch

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.factorization import deconv as port_deconv
from factorizer_tpu_torch.ops.kernels import (
    windowed_nmf_multi_spatial_local, windowed_nmf_multi_spatial_plain, windowed_nmf_plain,
)
from factorizer_tpu_torch.parallel import (
    Slabs, all_gather_cat, cut_slab, initialize_distributed, model_parallel_mesh, on_slabs, run_processes, shard_batch,
)
from factorizer_tpu_torch.parallel.slabs import choose_cut, empty_route, is_whole, slab_cut, slab_route
from factorizer_tpu_torch.train import trainer
from factorizer_tpu_torch.utils.weights import flax_state_dict

torch.set_num_threads(1)

F64_TOL = 1e-10
WORLD = 3
OPT = dict(lr=1e-3, weight_decay=1e-2)
DECONVER = dict(encoder_depth=(1, 1), encoder_width=(4, 8), strides=(1, 2), decoder_depth=(1,), norm=ftt.InstanceNorm,
                act="relu", groups=-1, ratio=1, num_iters=2, update_filter=True)
# The reduced DynUNet that JAX's GSPMD step and the port's 3-slab step both run (e): 40 rows, 16 / 12 / 12 a slab.
JAX_DYNUNET = dict(in_channels=2, out_channels=3, kernel_size=(3, 3, 3), strides=(1, 2, 2), filters=(4, 8, 8))
JAX_SHAPE = (2, 2, 40, 8, 8)


def _gen() -> torch.Generator:
    return torch.Generator().manual_seed(1)


def _on_cpu(lib) -> dict:
    return {"device": "cpu"} if lib is ftt else {}


def _deep_factorizer(lib=ftt, **kw):
    """Four levels on 16^3, patches of 2: on 3 slabs 8 / 4 / 4 rows, K5 at levels 0 and 1, level 2's mixers gathered
    (a slab of one row), the bottleneck (half a row) gathered by the route."""
    if lib is ftt and "generator" not in kw:
        kw = {"generator": _gen(), **kw}
    return lib.Factorizer(4, 3, spatial_size=(16, 16, 16), encoder_depth=(1, 1, 1, 1), encoder_width=(4, 8, 8, 16),
                          strides=(1, 2, 2, 2), decoder_depth=(1, 1, 1), rank=1, num_iters=5, init_method="uniform",
                          solver="hals", reshape=(lib.SWMatricize, {"head_dim": 4, "patch_size": 2, "shifts": [None, 1]}),
                          **_on_cpu(lib), **kw)


# name -> (factory, (input channels, output channels, spatial size), slab rows at the input, route level)
CASES = {
    "factorizer": (_deep_factorizer, (4, 3, (16, 16, 16)), (8, 4, 4), 3),
    "deconver_filter": (lambda: ftt.Deconver(4, 3, spatial_dims=3, kernel_size=(3, 3, 3), **DECONVER, device="cpu",
                                             generator=_gen()), (4, 3, (16, 8, 8)), (6, 6, 4), None),
    "dynunet_deep_supervision": (lambda: ftt.DynUNet(4, 3, kernel_size=[3, 3, 3, 3], strides=[1, 2, 2, 2],
                                                     filters=[4, 8, 8, 16], deep_supervision=True, deep_supr_num=1,
                                                     device="cpu", generator=_gen()), (4, 3, (16, 8, 8)), (8, 4, 4), 3),
    "segresnet": (lambda: ftt.materialize(ftt.SegResNet(4, 3, init_filters=8, blocks_down=(1, 1, 1, 1),
                                                        blocks_up=(1, 1, 1), upsample_mode="linear", device="cpu",
                                                        generator=_gen()), 3), (4, 3, (16, 8, 8)), (8, 4, 4), 3),
    "swinunetr": (lambda: ftt.SwinUNETR(2, 1, img_size=(32, 32, 32), feature_size=6, device="cpu", generator=_gen()),
                  (2, 1, (32, 32, 32)), (16, 8, 8), 4),
    "unetr": (lambda: ftt.UNETR(2, 1, img_size=(32, 16, 16), feature_size=4, hidden_size=24, mlp_dim=48, num_heads=2,
                                num_layers=4, device="cpu", generator=_gen()), (2, 1, (32, 16, 16)), (11, 11, 10), 1),
}
BRATS_STRIDES = (1, 1, 2, 2, 2, 2)  # factorizer_brats23: the stem's, then its five stages'
# The cases held against one process and against JAX's GSPMD step, each built by both packages from the JAX weights:
# name -> (package -> model, input shape (B, C, *S), output channels, slab rows at the input, route level, which of
# the training outputs every process holds whole).  (d): more slabs than rows; (e): heads below the cut's grid, the
# fourth reading a level of 2 rows on 8 / 4 / 4.
GSPMD_CASES = {
    "dynunet_more_slabs_than_rows": (
        lambda lib: lib.DynUNet(2, 3, kernel_size=(3, 3, 3), strides=((1, 1, 1), (1, 2, 2), (1, 2, 2)), filters=(4, 8, 8),
                                deep_supervision=True, deep_supr_num=1, **_on_cpu(lib)),
        (2, 2, 2, 8, 8), 3, (1, 1, 0), 0, [False, False]),
    "factorizer_heads_below_grid": (lambda lib: _deep_factorizer(lib, num_deep_supr=4), (2, 4, 16, 16, 16), 3, (8, 4, 4), 3, [False, False, False, True]),
    "unet_heads_below_grid": (
        lambda lib: lib.UNet(4, 3, encoder_depth=(1, 1, 1, 1), encoder_width=(8, 8, 16, 16), strides=(1, 2, 2, 2),
                             decoder_depth=(1, 1, 1), stem=(lib.Conv, {"kernel_size": 3, "padding": 1}), num_deep_supr=4,
                             **_on_cpu(lib)),
        (2, 4, 16, 8, 8), 3, (8, 4, 4), 3, [False, False, False, True]),
    "deconver_heads_below_grid": (
        lambda lib: lib.Deconver(4, 3, spatial_dims=3, kernel_size=(3, 3, 3), encoder_depth=(1, 1, 1, 1),
                                 encoder_width=(4, 8, 8, 8), strides=(1, 2, 2, 2), decoder_depth=(1, 1, 1),
                                 norm=lib.InstanceNorm, act="relu", groups=-1, ratio=1, num_iters=2, num_deep_supr=4,
                                 **_on_cpu(lib)),
        (2, 4, 16, 8, 8), 3, (8, 4, 4), 3, [False, False, False, True]),
}


# -- (a) the cut as a pure function


@pytest.mark.parametrize("rows,n,strides,want", [
    (128, 2, BRATS_STRIDES, (64, 64)),
    (128, 4, BRATS_STRIDES, (32,) * 4),
    (64, 8, BRATS_STRIDES, (8,) * 8),
    (128, 3, BRATS_STRIDES, (48, 48, 32)),
    (128, 5, BRATS_STRIDES, (32, 32, 32, 16, 16)),
    (128, 6, BRATS_STRIDES, (32, 32, 16, 16, 16, 16)),
    (128, 7, BRATS_STRIDES, (32,) + (16,) * 6),
    (128, 9, BRATS_STRIDES, (16,) * 7 + (8, 8)),  # 16 grid rows of 8: the bottleneck below the grid
    (10, 3, (), (4, 3, 3)),                      # no strides: a grid of one row
    (32, 3, (16,), (11, 11, 10)),                # a stride the rows do not leave 3 of
    (40, 3, (1, 2, 2), (16, 12, 12)),
    (3, 3, BRATS_STRIDES, (1, 1, 1)),
    (2, 3, BRATS_STRIDES, (1, 1, 0)),            # more slabs than rows: a row each, then empty slabs
    (1, 4, (), (1, 0, 0, 0)),
])
def test_cut_rule(rows, n, strides, want):
    """Equal slabs where ``n`` divides the rows (every part 1); else near-equal on the grid of the longest stride
    product that leaves ``n`` grid rows, the first slabs one grid row more; offsets in order, and each slab whole at
    every level the grid holds."""
    cut = choose_cut(rows, n, strides)
    assert tuple(cut.sizes(rows)) == want and sum(want) == rows
    assert cut.is_equal == (rows % n == 0) and (not cut.is_equal or cut.parts == (1,) * n)
    assert cut.offsets(rows) == list(np.cumsum((0,) + want[:-1]))
    if not cut.is_equal:
        assert all(p in (max(cut.parts), max(cut.parts) - 1) for p in cut.parts) and list(cut.parts) == sorted(
            cut.parts, reverse=True)
        grid = rows // sum(cut.parts)
        products = list(itertools.accumulate(strides, operator.mul))
        assert grid == 1 or grid in products
        for product in products:  # the grid is a stride product, whole on every slab down to it
            if grid % product == 0:
                assert [r * product for r in cut.sizes(rows // product)] == list(want)


def test_cut_refuses_a_slab_without_a_row():
    """More slabs than rows no longer raises: the first R slabs hold a row each and the others none (parts 0), as
    GSPMD pads such a shard; every model's route then gathers the whole model (``empty_route``), and a slab that holds
    no row takes the input's rows as the whole; the model's own cut takes its strides (``slab_strides``).  An input of
    no row still raises."""
    cut = choose_cut(2, 3, BRATS_STRIDES)
    assert cut.parts == (1, 1, 0) and cut.empty == 1 and cut.describe() == "1 / 1 / 0"
    assert cut.keeps(2) and cut.keeps(4) and not cut.keeps(1) and cut.offsets(2) == [0, 1, 2]
    assert empty_route(cut).level == 0 and "3 slabs of an input of 2 rows: 1 hold no row" in empty_route(cut).reason
    assert empty_route(choose_cut(16, 3, BRATS_STRIDES)) is None
    with pytest.raises(ValueError, match="of an input of 0 rows"):
        choose_cut(0, 3, BRATS_STRIDES)
    model = CASES["dynunet_deep_supervision"][0]()
    assert model.slab_strides() == [1, 2, 2, 2] and slab_cut(model, 16, 3).sizes(16) == [8, 4, 4]
    assert slab_cut(model, 2, 3).sizes(2) == [1, 1, 0] and model.slab_route(slab_cut(model, 2, 3)).level == 0
    for name in ("factorizer", "segresnet", "swinunetr", "unetr"):
        assert CASES[name][0]().slab_route(choose_cut(2, 3)).level == 0, name


# -- (c) K5's ring of unequal slabs in one process


@pytest.mark.parametrize("rows", [(12, 4, 8), (8, 12, 4, 8)])
def test_k5_ring_of_unequal_slabs_equals_k1(rows):
    """K5 on slabs of unequal rows (multiples of the patch; a slab of one patch takes and sends halos of up to 3 of
    its 4 rows), joined, against K1's plain version on the whole volume, f64: the output and dx to 1e-12; the ring's
    plain version likewise."""
    rng = np.random.default_rng(5)
    shape = (2, sum(rows), 8, 8, 8)
    x = torch.from_numpy(rng.random(shape))
    u0, v0 = torch.from_numpy(rng.random((4, 1))), torch.from_numpy(rng.random((64, 1)))
    g = torch.from_numpy(rng.standard_normal(shape))
    shifts = ((2, 3, 1), None, 1, 3)
    xs = [t.contiguous().requires_grad_(True) for t in x.split(rows, 1)]
    y = torch.cat(windowed_nmf_multi_spatial_local(xs, u0, v0, 4, 4, shifts, "hals", 2, 1e-16), 1)
    y.backward(g)
    whole = x.clone().requires_grad_(True)
    ref = windowed_nmf_plain(whole, u0, v0, 4, 4, shifts, "hals", 2, 1e-16)
    ref.backward(g)
    plain = torch.cat(windowed_nmf_multi_spatial_plain(x.split(rows, 1), u0, v0, 4, 4, shifts, "hals", 2, 1e-16), 1)
    np.testing.assert_allclose(y.detach().numpy(), ref.detach().numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(plain.numpy(), ref.detach().numpy(), rtol=0, atol=1e-12)
    dx = torch.cat([t.grad for t in xs], 1)
    np.testing.assert_allclose(dx.numpy(), whole.grad.numpy(), rtol=0, atol=1e-12 * float(whole.grad.abs().max()))


# -- (b), (d), (e): one spawn of 3 processes


def _batch(c_in: int, c_out: int, size: tuple, b: int = 2, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.standard_normal((b, c_in, *size))),
            "label": torch.from_numpy((rng.random((b, c_out, *size)) > 0.7).astype(np.float64))}


def _run(name: str, mesh=None) -> dict:
    """The model's eval forward and one train step, on this process's slab of the model's cut when ``mesh`` is given;
    for the Deconver also the first stage's filter fitted on slabs."""
    factory, (c_in, c_out, size), _, _ = CASES[name]
    model = factory().double()
    batch = _batch(c_in, c_out, size)
    report = {}
    model.eval()
    with torch.no_grad():
        if mesh is None:
            report["logits"] = model(batch["image"])
        else:
            cut = slab_cut(model, size[0], WORLD)
            slabs = Slabs(mesh, "model", cut)
            x = shard_batch(batch["image"], mesh, data_axis=None, spatial_axis="model", sizes=cut.sizes(size[0]))
            report.update(route=slab_route(model, cut), rows=tuple(cut.sizes(size[0])), slab=x.shape[2])
            with on_slabs(model, slabs):
                report["logits"] = all_gather_cat(model(x), mesh, "model", 2, sizes=cut.sizes(size[0]))
        if name.startswith("deconver"):
            deconv = next(m for m in model.modules() if isinstance(m, port_deconv.Deconv))
            a = torch.from_numpy(np.random.default_rng(4).random((2, *size, 4)))
            if mesh is None:
                report["h"] = deconv.fit(a)[1]
            else:
                with on_slabs(model, slabs):
                    report["h"] = deconv.fit(shard_batch(a.movedim(-1, 1), mesh, None, "model", cut.sizes(size[0]))
                                             .movedim(1, -1).contiguous())[1]
    state = trainer.create_train_state(model, device="cpu", **OPT)
    step = trainer.make_train_step(model) if mesh is None else trainer.make_train_step(model, mesh=mesh,
                                                                                        spatial_axis="model")
    state, metrics = step(state, batch)
    report.update(loss=metrics["loss"].item(), grads={k: p.grad.clone() for k, p in model.named_parameters()},
                  params={k: p.detach().clone() for k, p in model.named_parameters()},
                  cleared=all(getattr(m, "slabs", None) is None for m in model.modules()))
    return report


def _jax_dynunet_run(mesh, variables) -> dict:
    """The reduced DynUNet with the JAX model's weights, one spatial step at lr 0: loss and gradients."""
    model = ftt.DynUNet(**JAX_DYNUNET, device="cpu").double()
    ftt.load_flax_variables(model, variables)
    batch = _batch(JAX_SHAPE[1], 3, JAX_SHAPE[2:], b=JAX_SHAPE[0], seed=9)
    state = trainer.create_train_state(model, device="cpu", lr=0.0)
    state, metrics = trainer.make_train_step(model, mesh=mesh, spatial_axis="model")(state, batch)
    return {"loss": metrics["loss"].item(), "grads": {k: p.grad.clone() for k, p in model.named_parameters()}}


def _gspmd_batch(name: str) -> dict:
    _, shape, c_out, _, _, _ = GSPMD_CASES[name]
    return _batch(shape[1], c_out, shape[2:], b=shape[0], seed=11)


def _gspmd_run(name: str, variables: dict, mesh=None) -> dict:
    """A case of ``GSPMD_CASES`` with the JAX model's weights: the training outputs of the first sample (gathered on
    slabs where a slab, as they are where whole), then one step at lr 0 (its loss and gradients); on this process's
    slab of the model's cut when ``mesh`` is given."""
    factory, shape, _, _, _, _ = GSPMD_CASES[name]
    model = ftt.load_flax_variables(factory(ftt), variables).double().train()
    batch = _gspmd_batch(name)
    report = {}
    with torch.no_grad():
        if mesh is None:
            outs = model(batch["image"][:1])
            report["whole"] = [False] * len(outs)
        else:
            slabs = Slabs(mesh, "model", slab_cut(model, shape[2], WORLD))
            x = shard_batch(batch["image"][:1], mesh, data_axis=None, spatial_axis="model",
                            sizes=slabs.cut.sizes(shape[2]))
            with on_slabs(model, slabs):
                slab_outs = model(x)
            report.update(route=slab_route(model, slabs.cut), rows=tuple(slabs.cut.sizes(shape[2])), slab=x.shape[2],
                          whole=[is_whole(t) for t in slab_outs])
            outs = [t if is_whole(t) else slabs.gather_slabs(t, dim=2) for t in slab_outs]
    report["outputs"] = outs
    state = trainer.create_train_state(model, device="cpu", lr=0.0)
    step = trainer.make_train_step(model) if mesh is None else trainer.make_train_step(model, mesh=mesh,
                                                                                        spatial_axis="model")
    state, metrics = step(state, batch)
    report.update(loss=metrics["loss"].item(), grads={k: p.grad.clone() for k, p in model.named_parameters()},
                  cleared=all(getattr(m, "slabs", None) is None for m in model.modules()))
    return report


def _zero_rows(mesh) -> dict:
    """``all_gather_cat`` and ``cut_slab`` over slabs of 2 / 1 / 0 rows, with ``cut_slab``'s backward (the gather of
    the cotangents, an empty one among them)."""
    i = mesh.axis_index("model")
    sizes = (2, 1, 0)
    mine = torch.arange(sizes[i] * 4, dtype=torch.float64).reshape(1, sizes[i], 4) + 100 * i
    whole = torch.arange(12, dtype=torch.float64).reshape(1, 3, 4).requires_grad_(True)
    part = cut_slab(whole, mesh, "model", 1, sizes=sizes)
    (part * (i + 1)).sum().backward()
    return {"gathered": all_gather_cat(mine, mesh, "model", 1, sizes=sizes), "part": part.detach(),
            "grad": whole.grad.clone()}


def _worker(rank, world, init_method, variables):
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = model_parallel_mesh()
    report = {name: _run(name, mesh) for name in CASES}
    report["zero_rows"] = _zero_rows(mesh)
    report["gspmd"] = {name: _gspmd_run(name, variables[name], mesh) for name in GSPMD_CASES}
    report["jax_dynunet"] = _jax_dynunet_run(mesh, variables["dynunet"])
    return report


def _jax_variables() -> dict:
    import jax
    import jax.numpy as jnp

    import factorizer_tpu as ftx

    variables = {"dynunet": jax.jit(ftx.DynUNet(**JAX_DYNUNET).init)(jax.random.key(3), jnp.zeros((1, *JAX_SHAPE[1:])))}
    for name, (factory, shape, _, _, _, _) in GSPMD_CASES.items():
        init = jax.jit(lambda key, x, model=factory(ftx): model.init(key, x, train=True))  # the training heads too
        variables[name] = init(jax.random.key(3), jnp.zeros((1, *shape[1:])))
    return {name: jax.tree.map(np.asarray, dict(v)) for name, v in variables.items()}


@pytest.fixture(scope="module")
def jax_variables():
    return _jax_variables()


@pytest.fixture(scope="module")
def three_slabs(jax_variables):
    return run_processes(_worker, WORLD, jax_variables, timeout=300)


_REFERENCE = {}


def _reference(name: str) -> dict:
    if name not in _REFERENCE:
        _REFERENCE[name] = _run(name)
    return _REFERENCE[name]


def _close(a: torch.Tensor, b: torch.Tensor, scale: float) -> None:
    assert a.shape == b.shape and (a - b).abs().max().item() <= F64_TOL * scale


@pytest.mark.parametrize("name", list(CASES))
def test_three_unequal_slabs_equal_one_process(three_slabs, name):
    """On 3 slabs of unequal rows, f64: the eval logits, the step's loss, every gradient and the parameters after one
    AdamW step as one process's to 1e-10 of the largest magnitude; the three processes' parameters equal bit for bit;
    the slab rows and the route as the cut gives them (the Factorizer's, DynUNet's and SegResNet's bottleneck below
    the grid, gathered; SwinUNETR's level 4; UNETR's ViT on a cut of one-row grid, all but the finest level gathered;
    the Deconver every level on slabs); the Deconver's filter fitted on slabs equal on every process and to one
    process's."""
    _, _, rows, level = CASES[name]
    want = _reference(name)
    for rank, r in enumerate(three_slabs):
        got = r[name]
        assert got["rows"] == rows and got["slab"] == rows[rank]
        assert got["route"].level == level, got["route"]
        _close(got["logits"], want["logits"], want["logits"].abs().max().item())
        assert abs(got["loss"] - want["loss"]) <= F64_TOL * abs(want["loss"])
        assert got["grads"].keys() == want["grads"].keys()
        largest = max(g.abs().max().item() for g in want["grads"].values())
        for key, g in want["grads"].items():
            _close(got["grads"][key], g, largest)
        largest = max(p.abs().max().item() for p in want["params"].values())
        for key, p in want["params"].items():
            _close(got["params"][key], p, largest)
            assert torch.equal(got["params"][key], three_slabs[0][name]["params"][key]), key
        assert got["cleared"]
        if "h" in want:
            assert torch.equal(got["h"], three_slabs[0][name]["h"])
            _close(got["h"], want["h"], want["h"].abs().max().item())


def _gspmd_reference(name: str, jax_variables: dict) -> dict:
    key = ("gspmd", name)
    if key not in _REFERENCE:
        _REFERENCE[key] = _gspmd_run(name, jax_variables[name])
    return _REFERENCE[key]


def _check_against_one_process(name: str, three_slabs, jax_variables) -> None:
    """A case of ``GSPMD_CASES`` on 3 slabs against one process, f64: the training outputs (each gathered where a
    slab; the whole ones as every process holds them), the step's loss and every gradient to 1e-10 of the largest;
    the slab rows, the route and which outputs are whole as the case states them; the slabs cleared after."""
    _, _, _, rows, level, whole = GSPMD_CASES[name]
    want = _gspmd_reference(name, jax_variables)
    for rank, r in enumerate(three_slabs):
        got = r["gspmd"][name]
        assert got["rows"] == rows and got["slab"] == rows[rank] and got["whole"] == whole
        assert got["route"].level == level, got["route"]
        assert len(got["outputs"]) == len(want["outputs"])
        for a, b in zip(got["outputs"], want["outputs"]):
            _close(a, b, b.abs().max().item())
        assert abs(got["loss"] - want["loss"]) <= F64_TOL * abs(want["loss"])
        assert got["grads"].keys() == want["grads"].keys()
        largest = max(g.abs().max().item() for g in want["grads"].values())
        for key, g in want["grads"].items():
            _close(got["grads"][key], g, largest)
        assert got["cleared"]


def test_a_slab_without_a_row_raises_on_every_process(three_slabs, jax_variables):
    """3 slabs of an input of 2 rows no longer raise: a DynUNet of stride 1 along the cut axis with a deep-supervision
    head runs on slabs of 1 / 1 / 0 rows, the whole model gathered (route 0, named by the empty slab), and equals one
    process in f64 on every process, the empty slab's among them (the spawn returned, so none waited for another)."""
    _check_against_one_process("dynunet_more_slabs_than_rows", three_slabs, jax_variables)
    for r in three_slabs:
        assert "3 slabs of an input of 2 rows: 1 hold no row" in r["gspmd"]["dynunet_more_slabs_than_rows"]["route"].reason


@pytest.mark.parametrize("name", ["factorizer_heads_below_grid", "unet_heads_below_grid", "deconver_heads_below_grid"])
def test_heads_below_the_grid_equal_one_process(three_slabs, jax_variables, name):
    """``num_deep_supr: 4`` on 8 / 4 / 4 rows: head 3 reads a level of 2 rows (shares 1 / 1/2 / 1/2), which runs
    gathered with its head; every process returns that head's whole output (``is_whole``), the others their slabs,
    and the deep-supervision loss takes its term whole: outputs, loss and gradients as one process's, f64."""
    _check_against_one_process(name, three_slabs, jax_variables)


def test_collectives_of_zero_rows(three_slabs):
    """``all_gather_cat(sizes=)`` over slabs of 2 / 1 / 0 rows joins them in axis order on every process (the empty
    slab padded to the largest and trimmed), and ``cut_slab``'s cut and its backward (a gather of the cotangents,
    the empty one among them) give each process its rows and the whole cotangent."""
    want = torch.cat([torch.arange(s * 4, dtype=torch.float64).reshape(1, s, 4) + 100 * i
                      for i, s in enumerate((2, 1, 0))], 1)
    whole = torch.arange(12, dtype=torch.float64).reshape(1, 3, 4)
    grad = torch.cat([torch.full((1, 2, 4), 1.0), torch.full((1, 1, 4), 2.0)], 1).double()
    for rank, r in enumerate(three_slabs):
        got = r["zero_rows"]
        assert torch.equal(got["gathered"], want)
        assert torch.equal(got["part"], whole[:, [(0, 1), (2,), ()][rank]])
        assert torch.equal(got["grad"], grad)


def test_three_slabs_agree_with_jax_gspmd(three_slabs, jax_variables):
    """JAX's own spatial step (``make_train_step(mesh, spatial_axis="model")``, GSPMD padding 40 rows over a model
    axis of 3 XLA CPU devices) against the port's 3 slabs of 16 / 12 / 12 rows, f64: the loss to 1e-10 and every
    gradient to 1e-10 of the largest (the JAX gradients from an update of ``optax.scale(1)``: the difference of the
    parameters, exact to 1e-16 of them)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    import factorizer_tpu as ftx
    from factorizer_tpu.train import trainer as jax_trainer

    batch = _batch(JAX_SHAPE[1], 3, JAX_SHAPE[2:], b=JAX_SHAPE[0], seed=9)
    with jax.enable_x64(True):
        mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(1, WORLD), ("data", "model"))
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jax_variables["dynunet"]["params"])
        tx = optax.scale(1.0)
        state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=params, buffers={},
                                       opt_state=jax_trainer.init_opt_state(tx, params, False), tx=tx, flat_opt=False)
        step = jax_trainer.make_train_step(ftx.DynUNet(**JAX_DYNUNET), mesh=mesh, spatial_axis="model", donate=False)
        new, metrics = step(state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, jax.random.key(0))
        grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), new.params, params)
        loss = float(metrics["loss"])
    want = flax_state_dict(ftt.DynUNet(**JAX_DYNUNET, device="cpu").double(), {"params": grads})
    largest = max(np.abs(want[k].numpy()).max() for k in three_slabs[0]["jax_dynunet"]["grads"])
    for r in three_slabs:
        port = r["jax_dynunet"]
        assert abs(port["loss"] - loss) <= F64_TOL * abs(loss)
        for key, g in port["grads"].items():
            assert np.abs(g.numpy() - want[key].numpy()).max() <= F64_TOL * largest, key


@pytest.mark.parametrize("name", list(GSPMD_CASES))
def test_slab_cases_agree_with_jax_gspmd(three_slabs, jax_variables, name):
    """JAX's own spatial step on 3 XLA CPU devices (GSPMD pads 2 rows over 3 devices, and 16 rows whose deepest head
    reads 2) against the port's 3 slabs, f64: the loss to 1e-10 and every gradient to 1e-10 of the largest (the JAX
    gradients from an update of ``optax.scale(1)``)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    import factorizer_tpu as ftx
    from factorizer_tpu.train import trainer as jax_trainer

    factory = GSPMD_CASES[name][0]
    variables = jax_variables[name]
    batch = _gspmd_batch(name)
    with jax.enable_x64(True):
        mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(1, WORLD), ("data", "model"))
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        buffers = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables.get("buffers", {}))
        tx = optax.scale(1.0)
        state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=params, buffers=buffers,
                                       opt_state=jax_trainer.init_opt_state(tx, params, False), tx=tx, flat_opt=False)
        step = jax_trainer.make_train_step(factory(ftx), mesh=mesh, spatial_axis="model", donate=False)
        new, metrics = step(state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, jax.random.key(0))
        grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), new.params, params)
        loss = float(metrics["loss"])
    want = flax_state_dict(factory(ftt).double(), {**variables, "params": grads})
    largest = max(np.abs(want[k].numpy()).max() for k in three_slabs[0]["gspmd"][name]["grads"])
    for r in three_slabs:
        port = r["gspmd"][name]
        assert abs(port["loss"] - loss) <= F64_TOL * abs(loss)
        for key, g in port["grads"].items():
            assert np.abs(g.numpy() - want[key].numpy()).max() <= F64_TOL * largest, key
