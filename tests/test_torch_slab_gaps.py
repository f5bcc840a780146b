"""The spatial step where a part has no slab path or its slab holds too few rows: the gathered route and the filter update.

gloo processes on the CPU, float64, reduced models; each case's gathered
logits (eval mode), the spatial step's loss, every parameter gradient and the
parameters after one AdamW step equal one process's forward and step on the
whole volume to 1e-10 of the largest magnitude, as ``tests/test_torch_slabs.py``
holds the slab paths:

* the Deconver with ``update_filter: true`` on 2 and on 4 slabs: the filter
  update's two correlations summed over the slabs (``slab_sum``), no gather,
  and the fitted filter ``h`` bit for bit equal on every process;
* SwinUNETR V2 on 2 slabs of 16 rows and 4 of 8 (its stage convolutions
  inside the gathered transformer, ``encoder10`` and the upsampling from it
  gathered with it, on 4 slabs ``encoder4``'s level too); SwinUNETR at 64
  rows on 4 slabs (16 rows: level 5 gathered);
* DynUNet (with a deep-supervision head) and the Factorizer on 4 slabs whose
  deepest level holds half a row: that level gathered, K1 on its mixers;
  the Factorizer with ``remat`` (the recompute runs gathered as its forward);
  SegResNet (linear upsampling) likewise, and UNETR on slabs that hold no
  whole patch (every level but the finest gathered);
* the Factorizer with a block norm outside ``SLAB_NORMS`` (a norm over the
  whole volume) or a stem with no slab path: the whole model gathered; with
  ``FlaxLayerNorm``: every level on slabs; on 2 and 4 slabs;
* the Factorizer with ``dropout: 0.3`` in training on 4 slabs: the gathered
  bottleneck's output equal on every process (one mask, drawn alike), and
  the processes' parameters after a step equal.

Each case also pins its route (``parallel.slabs.slab_route``).  The workers are
module-level functions run by ``parallel.run_processes``.
"""

import numpy as np
import pytest
import torch

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.factorization import deconv as port_deconv
from factorizer_tpu_torch.layers.basic import FlaxLayerNorm
from factorizer_tpu_torch.parallel import (
    Slabs, all_gather_cat, initialize_distributed, model_parallel_mesh, on_slabs, run_processes,
)
from factorizer_tpu_torch.parallel import collectives
from factorizer_tpu_torch.parallel.slabs import Cut, slab_route
from factorizer_tpu_torch.train import trainer

torch.set_num_threads(1)

F64_TOL = 1e-10
OPT = dict(lr=1e-3, weight_decay=1e-2)
DECONVER = dict(encoder_depth=(1, 1), encoder_width=(4, 8), strides=(1, 2), decoder_depth=(1,), norm=ftt.InstanceNorm,
                act="relu", groups=-1, ratio=1, num_iters=2, update_filter=True)


def _gen() -> torch.Generator:
    return torch.Generator().manual_seed(1)


class VolumeNorm(torch.nn.Module):
    """Each channel scaled by its root mean square over the whole volume: a norm with no slab path."""

    def __init__(self, dim: int, dtype=None, device=None) -> None:
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, x.ndim - 1))
        return x * torch.rsqrt(x.square().mean(axes, keepdim=True) + 1e-5) * self.weight


def _factorizer(size=(32, 8, 8), strides=(1, 2), widths=(8, 16), depth=None, patch=4, **options):
    shifts = [None, 1, 2, 3] if patch == 4 else [None, 1]
    n = len(strides)
    return ftt.Factorizer(4, 3, spatial_size=size, encoder_depth=depth or (1,) * n, encoder_width=widths,
                          strides=strides, decoder_depth=(1,) * (n - 1), rank=1, num_iters=5, init_method="uniform",
                          solver="hals", reshape=(ftt.SWMatricize, {"head_dim": 4, "patch_size": patch, "shifts": shifts}),
                          device="cpu", generator=_gen(), **options)


def _deep_factorizer(**options):
    """Four levels on 16^3 (patches of 2): on 4 slabs 4, 2, 1 and 1/2 rows, so the bottleneck runs gathered."""
    return _factorizer((16, 16, 16), strides=(1, 2, 2, 2), widths=(4, 8, 8, 16), patch=2, **options)


class CentredStem(torch.nn.Module):
    """A stem that centres each volume along its first spatial axis: a layer no slab path is known for."""

    def __init__(self, in_channels: int, out_channels: int, device=None, generator=None) -> None:
        super().__init__()
        self.proj = ftt.Conv(in_channels, out_channels, kernel_size=1, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x - x.mean(1, keepdim=True))


# name -> (factory, (input channels, output channels, spatial size), {slab count: route level})
CASES = {
    "deconver_filter": (lambda: ftt.Deconver(4, 3, spatial_dims=3, kernel_size=(3, 3, 3), **DECONVER, device="cpu",
                                             generator=_gen()), (4, 3, (16, 8, 8)), {2: None, 4: None}),
    "swinunetr_v2": (lambda: ftt.SwinUNETR(2, 1, img_size=(32, 32, 32), feature_size=6, use_v2=True, device="cpu",
                                           generator=_gen()), (2, 1, (32, 32, 32)), {2: 5, 4: 4}),
    "factorizer_volume_norm": (lambda: _factorizer(norm=VolumeNorm), (4, 3, (32, 8, 8)), {2: 0, 4: 0}),
    "factorizer_flax_layer_norm": (lambda: _factorizer(norm=FlaxLayerNorm), (4, 3, (32, 8, 8)), {2: None, 4: None}),
    "factorizer_centred_stem": (lambda: _factorizer(stem=CentredStem), (4, 3, (32, 8, 8)), {4: 0}),
    "swinunetr_64_rows": (lambda: ftt.SwinUNETR(2, 1, img_size=(64, 32, 32), feature_size=6, device="cpu",
                                                generator=_gen()), (2, 1, (64, 32, 32)), {4: 5}),
    "dynunet_half_row": (lambda: ftt.DynUNet(4, 3, kernel_size=[3, 3, 3, 3], strides=[1, 2, 2, 2], filters=[4, 8, 8, 16],
                                             deep_supervision=True, deep_supr_num=1, device="cpu", generator=_gen()),
                         (4, 3, (16, 8, 8)), {4: 3}),
    "factorizer_half_row": (_deep_factorizer, (4, 3, (16, 16, 16)), {4: 3}),
    "factorizer_half_row_remat": (lambda: _deep_factorizer(remat=True), (4, 3, (16, 16, 16)), {4: 3}),
    "segresnet_half_row": (lambda: ftt.materialize(ftt.SegResNet(4, 3, init_filters=8, blocks_down=(1, 1, 1, 1),
                                                                 blocks_up=(1, 1, 1), upsample_mode="linear",
                                                                 device="cpu", generator=_gen()), 3),
                           (4, 3, (16, 8, 8)), {4: 3}),
    "unetr_part_patch": (lambda: ftt.UNETR(2, 1, img_size=(32, 16, 16), feature_size=4, hidden_size=24, mlp_dim=48,
                                           num_heads=2, num_layers=4, device="cpu", generator=_gen()),
                         (2, 1, (32, 16, 16)), {4: 1}),
}
TWO = [name for name, case in CASES.items() if 2 in case[2]]
FOUR = [name for name, case in CASES.items() if 4 in case[2]]


def _batch(name: str, b: int = 2) -> dict:
    c_in, c_out, size = CASES[name][1]
    rng = np.random.default_rng(0)
    return {"image": torch.from_numpy(rng.standard_normal((b, c_in, *size))),
            "label": torch.from_numpy((rng.random((b, c_out, *size)) > 0.7).astype(np.float64))}


def _first_deconv(model):
    return next(m for m in model.modules() if isinstance(m, port_deconv.Deconv))


def _fit_input(name: str) -> torch.Tensor:
    """A nonnegative activation for the first stage's Deconv, ``(B, *S, C)``."""
    _, _, size = CASES[name][1]
    return torch.from_numpy(np.random.default_rng(4).random((2, *size, 4)))


def _run(name: str, mesh=None) -> dict:
    """The model's eval forward and one train step, on this process's slabs when ``mesh`` is given; for the Deconver
    also the first stage's fitted filter."""
    model = CASES[name][0]().double()
    batch = _batch(name)
    slabs = None if mesh is None else Slabs(mesh, "model")
    report = {}
    model.eval()
    with torch.no_grad():
        if slabs is None:
            logits = model(batch["image"])
        else:
            x = batch["image"].chunk(slabs.n, 2)[slabs.index].contiguous()
            report["route"] = slab_route(model, Cut.equal(x.shape[2] * slabs.n, slabs.n))
            with on_slabs(model, slabs):
                out = model(x)
                logits = ([all_gather_cat(y, mesh, "model", 2) for y in out] if isinstance(out, list)
                          else all_gather_cat(out, mesh, "model", 2))
        if name.startswith("deconver"):
            deconv, a = _first_deconv(model), _fit_input(name)
            if slabs is None:
                report["h"] = deconv.fit(a)[1]
            else:
                with on_slabs(model, slabs):
                    s, h = deconv.fit(a.chunk(slabs.n, 1)[slabs.index].contiguous())
                report["h"], report["s"] = h, all_gather_cat(s, mesh, "model", 1)
    state = trainer.create_train_state(model, device="cpu", **OPT)
    step = trainer.make_train_step(model) if mesh is None else trainer.make_train_step(model, mesh=mesh,
                                                                                        spatial_axis="model")
    gathers = [0]
    gather = collectives.all_gather_cat

    def counted(*args, **kwargs):
        gathers[0] += 1
        return gather(*args, **kwargs)

    collectives.all_gather_cat = counted
    try:
        state, metrics = step(state, batch)
    finally:
        collectives.all_gather_cat = gather
    report.update(logits=logits, loss=metrics["loss"].item(), gathers=gathers[0],
                  grads={k: p.grad.clone() for k, p in model.named_parameters()},
                  params={k: p.detach().clone() for k, p in model.named_parameters()},
                  cleared=all(getattr(m, "slabs", None) is None for m in model.modules()))
    return report


def _dropout_run(mesh) -> dict:
    """The deep Factorizer with dropout 0.3 in training, on 4 slabs: its gathered bottleneck's output (a forward hook)
    and the parameters after one step."""
    model = _deep_factorizer(dropout=0.3).double()
    slabs = Slabs(mesh, "model")
    seen = []
    model.encoder.blocks[3].register_forward_hook(lambda mod, args, out: seen.append(out.detach().clone()))
    torch.manual_seed(100 + slabs.index)  # each process its own stream: the gathered part must not depend on it
    batch = _batch("factorizer_half_row")
    model.train()
    with torch.no_grad(), on_slabs(model, slabs):
        model(batch["image"].chunk(slabs.n, 2)[slabs.index].contiguous())
    state = trainer.create_train_state(model, device="cpu", **OPT)
    step = trainer.make_train_step(model, mesh=mesh, spatial_axis="model")
    state, metrics = step(state, batch)
    return {"bottleneck": seen, "loss": metrics["loss"].item(),
            "param_sum": sum(p.detach().sum().item() for p in model.parameters())}


def _worker(rank, world, init_method, names, dropout):
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = model_parallel_mesh()
    report = {name: _run(name, mesh) for name in names}
    if dropout:
        report["dropout"] = _dropout_run(mesh)
    return report


@pytest.fixture(scope="module")
def two_slabs():
    return run_processes(_worker, 2, TWO, False, timeout=400)


@pytest.fixture(scope="module")
def four_slabs():
    return run_processes(_worker, 4, FOUR, True, timeout=400)


_REFERENCE = {}


def _reference(name: str) -> dict:
    if name not in _REFERENCE:
        _REFERENCE[name] = _run(name)
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


@pytest.mark.parametrize("name", TWO)
def test_two_slabs_equal_one_process(two_slabs, name):
    """On 2 slabs, f64: logits, the step's loss, every gradient and the updated parameters as one process's to 1e-10;
    the route as the model's rule gives it: the Deconver with the filter update and the Factorizer with FlaxLayerNorm
    every level on slabs, SwinUNETR V2 (16 rows) level 5 gathered with its transformer, the Factorizer with a norm over
    the whole volume the whole model gathered."""
    want = _reference(name)
    for r in two_slabs:
        _assert_equal_to_one_process(r[name], want)
        assert r[name]["route"].level == CASES[name][2][2], r[name]["route"]
    if name == "factorizer_volume_norm":
        assert "VolumeNorm (blocks.0.norm1)" in two_slabs[0][name]["route"].reason
        assert str(two_slabs[0][name]["route"]).startswith("whole model gathered, no memory saving")


@pytest.mark.parametrize("name", FOUR)
def test_four_slabs_equal_one_process(four_slabs, name):
    """On 4 slabs, f64 (the middle slabs take halos from both neighbours), as on 2: the Deconver's filter update;
    SwinUNETR V2 at 32 rows (8 a slab: level 4 gathered) and at 64 rows (16 a slab: level 5 gathered); the Factorizer
    with a whole-volume norm and with a stem of no slab path (the whole model gathered), with FlaxLayerNorm (every
    level on slabs); DynUNet, SegResNet and the Factorizer (also under remat) whose deepest level holds half a row a
    slab (level 3 gathered); UNETR on slabs of 8 rows, no whole patch of 16 (levels 1 and deeper gathered)."""
    want = _reference(name)
    for r in four_slabs:
        _assert_equal_to_one_process(r[name], want)
        assert r[name]["route"].level == CASES[name][2][4], r[name]["route"]


def test_filter_update_runs_on_slabs_and_stays_equal(two_slabs, four_slabs):
    """The Deconver's filter update on 2 and 4 slabs: no gather in the step (the correlations are summed, not
    gathered), the fitted filter ``h`` of the first stage equal bit for bit on every process and to one process's
    to 1e-10, the fitted source as one process's."""
    want = _reference("deconver_filter")
    for reports in (two_slabs, four_slabs):
        hs = [r["deconver_filter"]["h"] for r in reports]
        assert all(torch.equal(h, hs[0]) for h in hs)
        assert (hs[0] - want["h"]).abs().max().item() <= F64_TOL * want["h"].abs().max().item()
        assert all(r["deconver_filter"]["gathers"] == 0 for r in reports)
        assert torch.equal(reports[0]["deconver_filter"]["s"], reports[-1]["deconver_filter"]["s"])


def test_dropout_in_a_gathered_part_draws_alike(four_slabs):
    """The deep Factorizer with dropout 0.3 in training on 4 slabs, each process seeded differently: the gathered
    bottleneck's output is equal bit for bit on every process (the forward and the step's), so the part is one
    computation; the step's loss and the parameters after it are equal on every process."""
    runs = [r["dropout"] for r in four_slabs]
    assert len(runs[0]["bottleneck"]) == 2
    for r in runs:
        assert all(torch.equal(a, b) for a, b in zip(r["bottleneck"], runs[0]["bottleneck"]))
        assert r["loss"] == runs[0]["loss"] and r["param_sum"] == runs[0]["param_sum"]
    assert not torch.equal(runs[0]["bottleneck"][0], runs[0]["bottleneck"][1])  # the masks are drawn anew
