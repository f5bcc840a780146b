"""The slab paths of the spatial step (``parallel.slabs``) on gloo processes on the CPU, float64.

Each model family that a bundle ships, reduced, runs its forward and one
spatial train step (``make_train_step(model, mesh=model_parallel_mesh(),
spatial_axis="model")``, AdamW) on 2 slabs of the volume's first spatial axis;
the Deconver also on 4, where the middle slabs have two neighbours.  The
gathered logits, the step's loss, every parameter gradient and the parameters
after the update equal one process's forward and step on the whole volume to
1e-10 of the largest magnitude among them:

* the Deconver, 3-D (k3) and 2-D (k7, slabs of H): InstanceNorm's statistics
  over the slabs, each of ``Deconv``'s three convolutions on its slab and a
  halo, the same number of K3 calls on each process as in one, no gather;
* DynUNet with and without deep supervision: k3 halos, stride-2 convolutions
  on even slabs, the heads' targets pooled per slab;
* SegResNet with linear upsampling: GroupNorm over the slabs, the resize's
  replicate-edged halo at both ends of the volume;
* SwinUNETR and UNETR: the transformer on the gathered tensor, its gradient
  counted once in the sum over the slabs;
* the Factorizer with InstanceNorm blocks, on its flat route (K4's plain
  version on the gathered tensor) and in 2-D (the flat route, slabs of H);
* the Factorizer with two deep-supervision heads (k1 convolutions on each
  slab, the heads' targets pooled per slab) and ``dropout: 0``.

Unit cases: ``slab_sum``'s backward against ``all_reduce_sum``'s, the
replicate-edged halo, ``_group_norm`` on slabs, the stride-2 refusal of the
layer itself; an overridden stem without a slab path gathers the whole model
(``tests/test_torch_slab_gaps.py`` covers the rest of the gathered route).  One
case holds the reduced Deconver's one-process forward against JAX's
``model.apply``.  The workers are module-level functions run by
``parallel.run_processes``; this module imports jax only inside a test.
"""

import numpy as np
import pytest
import torch

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.factorization import deconv as port_deconv
from factorizer_tpu_torch.layers.basic import Conv, _group_norm
from factorizer_tpu_torch.parallel import (
    Slabs, all_gather_cat, all_reduce_sum, halo_exchange, initialize_distributed, model_parallel_mesh, on_slabs,
    run_processes, slab_sum,
)
from factorizer_tpu_torch.parallel import collectives
from factorizer_tpu_torch.train import trainer

torch.set_num_threads(1)

F64_TOL = 1e-10
OPT = dict(lr=1e-3, weight_decay=1e-2)
DECONVER = dict(encoder_depth=(1, 1), encoder_width=(4, 8), strides=(1, 2), decoder_depth=(1,), norm=ftt.InstanceNorm,
                act="relu", groups=-1, ratio=1, num_iters=2)


def _gen() -> torch.Generator:
    return torch.Generator().manual_seed(1)


def _factorizer(size, in_channels=4, out_channels=3, **options):
    shifts = {"shifts": [None, 1, 2, 3]} if len(size) == 3 else {}
    return ftt.Factorizer(in_channels, out_channels, spatial_size=size, encoder_depth=(1, 1), encoder_width=(8, 16),
                          strides=(1, 2), decoder_depth=(1,), rank=1, num_iters=5, init_method="uniform", solver="hals",
                          reshape=(ftt.SWMatricize, {"head_dim": 4, "patch_size": 4, **shifts}), device="cpu",
                          generator=_gen(), **options)


# name -> (factory, (input channels, output channels, spatial size)); each factory draws its weights from one seed.
FAMILIES = {
    "deconver_3d": (lambda: ftt.Deconver(4, 3, spatial_dims=3, kernel_size=(3, 3, 3), **DECONVER, device="cpu",
                                         generator=_gen()), (4, 3, (16, 8, 8))),
    "deconver_2d": (lambda: ftt.Deconver(3, 1, spatial_dims=2, kernel_size=(7, 7), **DECONVER, device="cpu",
                                         generator=_gen()), (3, 1, (32, 16))),
    "dynunet": (lambda: ftt.DynUNet(4, 3, kernel_size=[3, 3, 3], strides=[1, 2, 2], filters=[4, 8, 16], device="cpu",
                                    generator=_gen()), (4, 3, (16, 8, 8))),
    "dynunet_deep_supervision": (lambda: ftt.DynUNet(4, 3, kernel_size=[3, 3, 3], strides=[1, 2, 2], filters=[4, 8, 16],
                                                     deep_supervision=True, deep_supr_num=1, device="cpu",
                                                     generator=_gen()), (4, 3, (16, 8, 8))),
    "segresnet_linear": (lambda: ftt.materialize(ftt.SegResNet(4, 3, init_filters=8, blocks_down=(1, 1, 1),
                                                               blocks_up=(1, 1), upsample_mode="linear", device="cpu",
                                                               generator=_gen()), 3), (4, 3, (16, 8, 8))),
    "swinunetr": (lambda: ftt.SwinUNETR(2, 1, img_size=(64, 32, 32), feature_size=12, device="cpu", generator=_gen()),
                  (2, 1, (64, 32, 32))),
    "unetr": (lambda: ftt.UNETR(2, 1, img_size=(64, 16, 16), feature_size=4, hidden_size=24, mlp_dim=48, num_heads=2,
                                num_layers=4, device="cpu", generator=_gen()), (2, 1, (64, 16, 16))),
    "factorizer_instance_norm": (lambda: _factorizer((32, 8, 8), norm=ftt.InstanceNorm), (4, 3, (32, 8, 8))),
    "factorizer_flat": (lambda: _factorizer((32, 8, 8), factorize_options={"use_windowed": False}), (4, 3, (32, 8, 8))),
    "factorizer_2d": (lambda: _factorizer((32, 16), in_channels=3, out_channels=1), (3, 1, (32, 16))),
    "factorizer_deep_supervision": (lambda: _factorizer((32, 8, 8), num_deep_supr=2, dropout=0.0), (4, 3, (32, 8, 8))),
    "factorizer_whole_axis_stem": (lambda: _factorizer((32, 8, 8), stem=_WholeAxisStem), (4, 3, (32, 8, 8))),
}


def _batch(name: str, b: int = 2) -> dict:
    c_in, c_out, size = FAMILIES[name][1]
    rng = np.random.default_rng(0)
    return {"image": torch.from_numpy(rng.standard_normal((b, c_in, *size))),
            "label": torch.from_numpy((rng.random((b, c_out, *size)) > 0.7).astype(np.float64))}


class _Count:
    """Counts the calls of ``module.name`` within the block (the function still runs)."""

    def __init__(self, module, name: str) -> None:
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def counted(*args, **kwargs):
            self.calls += 1
            return self.fn(*args, **kwargs)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.fn)


def _forward_and_step(name: str, mesh=None) -> dict:
    """The model's eval forward and one train step, on this process's slabs when ``mesh`` is given."""
    model = FAMILIES[name][0]().double()
    batch = _batch(name)
    slabs = None if mesh is None else Slabs(mesh, "model")
    model.eval()
    with torch.no_grad():
        if slabs is None:
            logits = model(batch["image"])
        else:
            x = batch["image"].chunk(slabs.n, 2)[slabs.index].contiguous()
            with on_slabs(model, slabs):
                out = model(x)
                logits = ([all_gather_cat(y, mesh, "model", 2) for y in out] if isinstance(out, list)
                          else all_gather_cat(out, mesh, "model", 2))
    state = trainer.create_train_state(model, device="cpu", **OPT)
    step = trainer.make_train_step(model) if mesh is None else trainer.make_train_step(model, mesh=mesh,
                                                                                        spatial_axis="model")
    with _Count(port_deconv, "depthwise_conv") as k3, _Count(collectives, "all_gather_cat") as gathers:
        state, metrics = step(state, batch)
    return {"logits": logits, "loss": metrics["loss"].item(),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "params": {k: p.detach().clone() for k, p in model.named_parameters()},
            "k3_calls": k3.calls, "gathers": gathers.calls,
            "cleared": all(getattr(m, "slabs", None) is None for m in model.modules())}


def _families_worker(rank, world, init_method, names):
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = model_parallel_mesh()
    return {name: _forward_and_step(name, mesh) for name in names}


TWO_SLABS = list(FAMILIES)


@pytest.fixture(scope="module")
def two_slabs():
    return run_processes(_families_worker, 2, TWO_SLABS, timeout=400)


@pytest.fixture(scope="module")
def four_slabs():
    return run_processes(_families_worker, 4, ["deconver_3d"], timeout=300)


_REFERENCE = {}


def _reference(name: str) -> dict:
    if name not in _REFERENCE:
        _REFERENCE[name] = _forward_and_step(name)
    return _REFERENCE[name]


def _assert_equal_to_one_process(got: dict, want: dict) -> None:
    def close(a, b, scale):
        assert a.shape == b.shape and (a - b).abs().max().item() <= F64_TOL * scale

    for a, b in zip(*(x if isinstance(x, list) else [x] for x in (got["logits"], want["logits"]))):
        close(a, b, b.abs().max().item())
    assert type(got["logits"]) is type(want["logits"])
    assert abs(got["loss"] - want["loss"]) <= F64_TOL * abs(want["loss"])
    assert got["grads"].keys() == want["grads"].keys()
    largest = max(g.abs().max().item() for g in want["grads"].values())
    for key, g in want["grads"].items():
        close(got["grads"][key], g, largest)
    largest = max(p.abs().max().item() for p in want["params"].values())
    for key, p in want["params"].items():
        close(got["params"][key], p, largest)
    assert got["cleared"]


@pytest.mark.parametrize("name", TWO_SLABS)
def test_two_slabs_equal_one_process(two_slabs, name):
    """On 2 slabs, f64: the gathered logits (eval mode), the spatial step's loss, every parameter gradient and the
    parameters after one AdamW step equal one process's on the whole volume to 1e-10 of the largest magnitude, on
    both processes; ``on_slabs`` clears every layer's ``slabs`` again.  The Deconver makes as many K3 calls a process
    as one process makes and gathers nothing; the transformers gather the patch grid once in the step's forward and
    the cotangents of the 4 hidden states they return in its backward."""
    want = _reference(name)
    for r in two_slabs:
        _assert_equal_to_one_process(r[name], want)
        assert r[name]["k3_calls"] == want["k3_calls"]
    if name.startswith("deconver"):
        # 3 blocks x 2 iterations x 3 convolutions of the source update
        assert want["k3_calls"] == 3 * 2 * 3 and all(r[name]["gathers"] == 0 for r in two_slabs)
    if name in ("swinunetr", "unetr"):  # the patch grid forward, the 4 hidden states' cotangents backward
        assert all(r[name]["gathers"] == 1 + 4 for r in two_slabs)


def test_deconver_on_four_slabs(four_slabs):
    """The 3-D Deconver on 4 slabs (4 rows a slab at the first stage, 2 at the second): the middle slabs take a halo
    from both neighbours; logits, loss, gradients and parameters as on one process to 1e-10."""
    want = _reference("deconver_3d")
    for r in four_slabs:
        _assert_equal_to_one_process(r["deconver_3d"], want)
        assert r["deconver_3d"]["k3_calls"] == want["k3_calls"] and r["deconver_3d"]["gathers"] == 0


def test_deconver_one_process_matches_jax():
    """The reduced 3-D Deconver of the slab cases, one process, against the JAX model's ``apply`` on the same NumPy
    input with the same weights (``load_flax_variables``), f64 to 1e-10 of the largest logit."""
    import jax
    import jax.numpy as jnp

    import factorizer_tpu as ftx

    cfg = {**DECONVER, "norm": ftx.InstanceNorm}
    model_j = ftx.Deconver(4, 3, spatial_dims=3, kernel_size=(3, 3, 3), **cfg)
    x = _batch("deconver_3d")["image"].numpy()
    with jax.enable_x64(True):
        variables = jax.tree.map(np.asarray, dict(model_j.init(jax.random.key(0), jnp.asarray(x))))
        want = np.asarray(jax.jit(model_j.apply)(variables, jnp.asarray(x)))
    model_t = ftt.load_flax_variables(FAMILIES["deconver_3d"][0]().double(), variables).eval()
    with torch.no_grad():
        got = model_t(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_TOL * np.abs(want).max())


# -- the collectives and layers, one at a time


def _unit_inputs(world: int = 2) -> dict:
    rng = np.random.default_rng(5)
    shapes = {"x": (world, 6), "w": (world, 6), "t": (2, 4 * world, 3), "g": (2, 4 + 2 * 2, 3),
              "v": (2, 4 * world, 3, 8), "r": (2, 4 * world, 3, 8)}
    return {k: torch.from_numpy(rng.standard_normal(shape)) for k, shape in shapes.items()}


def _units_worker(rank, world, init_method):
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = model_parallel_mesh()
    slabs = Slabs(mesh, "model")
    d = _unit_inputs(world)
    report = {}
    # slab_sum / all_reduce_sum: y_r = x_r * m with m = sum over the slabs of sum(x_r), loss = sum_r sum(y_r * w_r)
    for label, reduce in (("slab_sum", slab_sum), ("all_reduce_sum", all_reduce_sum)):
        mine = d["x"][rank].clone().requires_grad_(True)
        m = reduce(mine.sum(), mesh, "model")
        (mine * m * d["w"][rank]).sum().backward()
        report[label] = all_gather_cat(mine.grad[None], mesh, "model")
    # the halos, zeros and replicate-edged, and their backward
    for edge in ("zeros", "replicate"):
        mine = d["t"].chunk(world, 1)[rank].clone().requires_grad_(True)
        out = halo_exchange(mine, mesh, "model", 2, dim=1, edge=edge)
        out.backward(d["g"])
        report[edge] = (out.detach(), all_gather_cat(mine.grad, mesh, "model", 1))
    # GroupNorm's statistics over the slabs, and their gradient
    mine = d["v"].chunk(world, 1)[rank].clone().requires_grad_(True)
    y = _group_norm(mine, 2, None, None, 1e-5, torch.float64, slabs)
    (y * d["r"].chunk(world, 1)[rank]).sum().backward()
    report["group_norm"] = (all_gather_cat(y.detach(), mesh, "model", 1), all_gather_cat(mine.grad, mesh, "model", 1))
    # the stride-2 refusal
    conv = Conv(3, 4, kernel_size=3, stride=2, padding=1, device="cpu", generator=_gen()).double()
    conv.slabs = slabs
    try:
        conv(torch.zeros(1, 5, 4, 4, 3, dtype=torch.float64))
    except ValueError as e:
        report["refusal"] = str(e)
    return report


@pytest.fixture(scope="module")
def units():
    return run_processes(_units_worker, 2, timeout=200)


def test_slab_sum_backward_sums_the_cotangents(units):
    """``y_r = x_r * m``, ``m = sum(x)`` over both slabs: ``slab_sum``'s backward gives each slab the whole
    ``d loss / d x_r = w_r m + sum_r' <x_r', w_r'>``; ``all_reduce_sum`` (right for a loss every process holds whole)
    gives each slab only its own term of the sum, a different gradient."""
    d = _unit_inputs()
    whole = d["x"].clone().requires_grad_(True)
    (whole * whole.sum() * d["w"]).sum().backward()
    for r in units:
        torch.testing.assert_close(r["slab_sum"], whole.grad, rtol=0, atol=1e-12)
        assert (r["all_reduce_sum"] - whole.grad).abs().max() > 1e-3


def test_halo_zeros_and_replicate_at_both_ends(units):
    """A halo of 2 rows on 2 slabs of 4: the neighbour's rows inside the volume; beyond it zeros, or the slab's edge
    row repeated (``edge="replicate"``), as ``F.pad``'s constant and replicate modes pad the whole tensor.  The
    backward returns each halo row's cotangent to the row it came from, the repeated edge rows' to the edge row."""
    d = _unit_inputs()
    for edge, mode in (("zeros", "constant"), ("replicate", "replicate")):
        whole = d["t"].clone().requires_grad_(True)
        padded = torch.nn.functional.pad(whole.movedim(1, -1), (2, 2), mode=mode).movedim(-1, 1)
        total = torch.zeros_like(padded)  # each slab's output is a window of the padded tensor
        for rank, r in enumerate(units):
            torch.testing.assert_close(r[edge][0], padded[:, 4 * rank: 4 * rank + 8].detach(), rtol=0, atol=0)
            total[:, 4 * rank: 4 * rank + 8] += d["g"]
        padded.backward(total)
        for r in units:
            torch.testing.assert_close(r[edge][1], whole.grad, rtol=0, atol=1e-12)


def test_group_norm_on_slabs_equals_the_whole_volume(units):
    """``_group_norm`` with ``slabs`` (2 groups of 4 channels): the whole volume's mean and centred variance through
    two ``slab_sum``s; the gathered output and gradient equal the one-process norm's to 1e-12."""
    d = _unit_inputs()
    whole = d["v"].clone().requires_grad_(True)
    y = _group_norm(whole, 2, None, None, 1e-5, torch.float64)
    (y * d["r"]).sum().backward()
    for rep in units:
        torch.testing.assert_close(rep["group_norm"][0], y.detach(), rtol=0, atol=1e-12)
        torch.testing.assert_close(rep["group_norm"][1], whole.grad, rtol=0, atol=1e-12)


def test_stride_two_refuses_an_odd_slab(units):
    """A k3 stride-2 convolution on a slab of 5 rows raises, naming the layer and the row count, on each process."""
    for r in units:
        assert "Conv(3 -> 4, k3 s2 p1)" in r["refusal"] and "got 5 rows" in r["refusal"]


class _WholeAxisStem(torch.nn.Module):
    """A stem that centres each volume along its first spatial axis: a layer no slab path is known for."""

    def __init__(self, in_channels: int, out_channels: int, device=None, generator=None) -> None:
        super().__init__()
        self.proj = Conv(in_channels, out_channels, kernel_size=1, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x - x.mean(1, keepdim=True))


def test_an_overridden_stem_without_a_slab_path_is_refused_by_name(two_slabs):
    """A stem override of a class without a known slab path is named by the route rule, which gathers the whole model
    (route level 0, printed as saving no memory) instead of refusing it: ``slab_path_missing`` is None and the spatial
    step is built; on 2 slabs its logits, loss, gradients and parameters equal one process's to 1e-10.  A DoubleConv
    stem, a k3 downsampling and the deep-supervision heads have slab paths: every level runs on slabs."""
    from factorizer_tpu_torch.parallel.slabs import Cut, require_slab_path, slab_route

    model = _factorizer((32, 8, 8), stem=_WholeAxisStem)
    assert model.slab_path_missing() is None
    require_slab_path(model)
    route = slab_route(model, Cut.equal(32, 2))
    assert route.level == 0 and route.reason == "_WholeAxisStem (stem) has no known slab path"
    assert str(route).startswith("whole model gathered, no memory saving")
    want = _reference("factorizer_whole_axis_stem")
    for r in two_slabs:
        _assert_equal_to_one_process(r["factorizer_whole_axis_stem"], want)
    known = _factorizer((32, 8, 8), stem=(ftt.DoubleConv, {}), downsample=(Conv, {"kernel_size": 3, "padding": 1}),
                        num_deep_supr=2)
    assert known.slab_path_missing() is None and slab_route(known, Cut.equal(32, 2)).level is None
