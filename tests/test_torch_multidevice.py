"""The bundles' multi-device training programs on the port, on gloo processes on the CPU.

``train_multidevice.yaml`` (``SegmentationTrainer`` on a data-parallel mesh,
each process's loader over its partition of the datalist) and
``train_tp.yaml`` (the whole-model spatial step: the volume's first spatial
axis cut over a ``model`` axis of processes, ``parallel.slabs``):

* a reduced Factorizer on a ``(32, 8, 8)`` volume on 2 slabs in float64:
  its stem's halo reaches both ends of the volume, the stages of 16 rows a
  slab run K5's plain passes, the bottleneck (8 rows) is gathered; the forward, DiceCE, and the spatial train step (loss, grad norm,
  every parameter gradient, the parameters after two updates) against one
  process on the whole volume to 1e-10, and that step's loss against JAX's
  ``make_train_step`` on the same weights and batch; the processes' loaders
  draw different batches and the step still takes one, the first process's;
* ``SegmentationTrainer(mesh=data_parallel_mesh())`` on 2 processes: the
  global batch (not a twice-cut one), equal parameters, only the primary
  writes, validation metrics averaged over the processes, a resume; unequal
  shards raise by name;
* DistributedDataParallel over every model family the bundles build, the
  12 bundles' ``train_multidevice.yaml`` trainers, ``train_tp.yaml``'s
  spatial step for all 12 bundles, with the parameters sharded by JAX's
  rule (``tests/test_torch_slabs.py`` holds each model family's slab path
  against one process, ``tests/test_torch_tensor_parallel.py`` the
  sharding), and one CLI run under ``torch.distributed.run``.

The workers are module-level functions run by ``parallel.run_processes``;
this module imports jax only inside the tests that need it.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.config import ConfigParser
from factorizer_tpu_torch.data import partition_datalist
from factorizer_tpu_torch.parallel import (
    Slabs,
    all_gather_cat,
    data_parallel_mesh,
    data_process_groups,
    initialize_distributed,
    model_parallel_mesh,
    on_slabs,
    run_processes,
)
from factorizer_tpu_torch.train import loop as port_loop
from factorizer_tpu_torch.train import trainer
from factorizer_tpu_torch.train.losses import dice_ce_loss
from torch_bundle_cases import (
    NNUNET_SMALL, ON_CPU, REPO, SEGRESNET_SMALL, SWINUNETR_SMALL, TINY_DECONVER, TINY_FACTORIZER, ZOO, bundle_config,
)
from torch_workflow_cases import write_cases

torch.set_num_threads(1)

# A reduced Factorizer on a volume long in its first axis: on 2 slabs its 32^ stages hold 16 rows (K5: the all-gather
# would send more bytes than the halos, FactMixer.gathers) and its bottleneck 8 (gathered, as every deep stage).
SP = (32, 8, 8)
CONFIG = dict(
    in_channels=4, out_channels=3, spatial_size=SP, encoder_depth=(1, 1), encoder_width=(8, 16), strides=(1, 2),
    decoder_depth=(1,), mlp_ratio=4, act="relu", rank=1, num_iters=5, init_method="uniform", solver="hals",
)
SW = {"head_dim": 4, "patch_size": 4, "shifts": [None, 1, 2, 3]}
OPT = dict(lr=1e-3, weight_decay=1e-2)
F64_TOL = 1e-10
# Each bundle's reduced network_def (as tests/test_torch_bundle.py builds them), on the CPU.
SMALL = {
    "factorizer_brats23": TINY_FACTORIZER, "factorizer_isles22": TINY_FACTORIZER,
    "deconver_brats23": TINY_DECONVER, "deconver_isles22": TINY_DECONVER,
    "deconver_fives": {**TINY_DECONVER, "roi_size": [32, 32]},
    "nnunet_brats23": {**NNUNET_SMALL, "roi_size": [16, 16, 16]}, "nnunet_isles22": {**NNUNET_SMALL, "roi_size": [16, 16, 16]},
    "nnunet_fives": {**NNUNET_SMALL, "roi_size": [32, 32]},
    "segresnet_brats23": {**SEGRESNET_SMALL, "roi_size": [16, 16, 16]},
    "segresnet_isles22": {**SEGRESNET_SMALL, "roi_size": [16, 16, 16]},
    "segresnet_fives": {**SEGRESNET_SMALL, "roi_size": [32, 32]},
    "swinunetr_isles22": SWINUNETR_SMALL,
}
BUNDLES = sorted(SMALL)
TP_MIN_WEIGHT_SIZE = 64


def _config(bundle: str, *overlays: str, **overrides) -> dict:
    return bundle_config(bundle, *overlays, **{**SMALL[bundle], **ON_CPU, **overrides})


def _model(variables=None):
    model = ftt.Factorizer(**CONFIG, reshape=(ftt.SWMatricize, SW), device="cpu",
                           generator=torch.Generator().manual_seed(1))
    if variables is not None:
        ftt.load_flax_variables(model, variables)
    return model


def _batch(b=2, seed=0, dtype=np.float64, shape=(4, 3, *SP)):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.standard_normal((b, shape[0], *shape[2:])).astype(dtype)),
            "label": torch.from_numpy((rng.random((b, shape[1], *shape[2:])) > 0.7).astype(dtype))}


def _slab(t: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    return t.chunk(world, 2)[rank].contiguous()


# -- the spatial step: the reduced Factorizer on 2 slabs, float64


def _spatial_worker(rank, world, init_method, variables):
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = model_parallel_mesh()
    slabs = Slabs(mesh, "model")
    report = {"shape": dict(mesh.shape), "groups": data_process_groups(mesh)}
    model = _model(variables).double()
    routes = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: routes.append((args[0].shape[1], mod.gathers(args[0]))))
             for m in model.modules() if isinstance(m, ftt.FactMixer)]
    x = _batch(seed=0)["image"]
    with torch.no_grad(), on_slabs(model, slabs):
        report["logits"] = all_gather_cat(model(_slab(x, rank, world)), mesh, "model", 2)
    for h in hooks:
        h.remove()
    report["routes"] = routes
    report["slabs_cleared"] = all(getattr(m, "slabs", None) is None for m in model.modules())

    logits = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, *SP)))
    mine = _slab(logits, rank, world).requires_grad_(True)
    loss = dice_ce_loss(mine, _slab(_batch(seed=0)["label"], rank, world), slabs=slabs)
    loss.backward()
    report["dice_ce"] = (loss.item(), all_gather_cat(mine.grad, mesh, "model", 2))

    state = trainer.create_train_state(model, device="cpu", **OPT)
    if rank:  # the first process's parameters reach the others when the step is built
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    step = trainer.make_train_step(model, mesh=mesh, spatial_axis="model", local_batch=True)
    # The loaders of a model line draw different batches; the step takes the first process's.
    state, metrics = step(state, _batch(seed=0 if rank == 0 else 1))
    report["step"] = (metrics["loss"].item(), metrics["grad_norm"].item(),
                      {k: p.grad.clone() for k, p in model.named_parameters()})
    state, metrics = step(state, _batch(seed=2 if rank == 0 else 3))
    report["second_loss"] = metrics["loss"].item()
    report["params"] = {k: p.detach().clone() for k, p in model.named_parameters()}
    return report


@pytest.fixture(scope="module")
def jax_variables():
    import jax
    import jax.numpy as jnp

    import factorizer_tpu as ftx

    model = ftx.Factorizer(**CONFIG, reshape=(ftx.SWMatricize, SW))
    return model, jax.tree.map(np.asarray, dict(jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 4, *SP)))))


@pytest.fixture(scope="module")
def spatial(jax_variables):
    """The two processes' reports, and the one-process forward, DiceCE and two steps on the whole volume."""
    _, variables = jax_variables
    reports = run_processes(_spatial_worker, 2, variables, timeout=300)
    model = _model(variables).double()
    with torch.no_grad():
        logits = model(_batch(seed=0)["image"])
    whole = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, *SP))).requires_grad_(True)
    loss = dice_ce_loss(whole, _batch(seed=0)["label"])
    loss.backward()
    state = trainer.create_train_state(model, device="cpu", **OPT)
    step = trainer.make_train_step(model)
    state, metrics = step(state, _batch(seed=0))
    first = (metrics["loss"].item(), metrics["grad_norm"].item(),
             {k: p.grad.clone() for k, p in model.named_parameters()})
    state, metrics = step(state, _batch(seed=2))
    ref = {"logits": logits, "dice_ce": (loss.item(), whole.grad), "step": first, "second_loss": metrics["loss"].item(),
           "params": {k: p.detach().clone() for k, p in model.named_parameters()}}
    return reports, ref


def test_spatial_forward_equals_the_whole_volume(spatial):
    """On 2 slabs of 16 rows, f64: the stem's halo (zeros beyond both ends of the volume), K5 at the two stages of 16
    rows a slab (patches of 4), the bottleneck of 8 rows gathered (its all-gather sends fewer bytes than K5's
    exchanges), the positional embedding's rows; the gathered logits equal the one-process forward to 1e-10.
    ``model_parallel_mesh()`` on 2 processes is ``{data 1, model 2}``, one loader group."""
    reports, ref = spatial
    for r in reports:
        assert r["shape"] == {"data": 1, "model": 2} and r["groups"] == (1, 0) and r["slabs_cleared"]
        assert r["routes"] == [(16, False), (8, True), (16, False)]
        np.testing.assert_allclose(r["logits"].numpy(), ref["logits"].numpy(), rtol=0,
                                   atol=F64_TOL * ref["logits"].abs().max().item())


def test_dice_ce_on_slabs_equals_the_whole_volume(spatial):
    """DiceCE with ``slabs``: the per-(sample, class) sums reduced over the slabs before the quotient, the BCE over
    the global voxel count; every process holds the whole volume's loss, and the gathered gradient is the whole
    volume's, f64 to 1e-10."""
    reports, ref = spatial
    loss, grad = ref["dice_ce"]
    for r in reports:
        assert abs(r["dice_ce"][0] - loss) <= F64_TOL * abs(loss)
        assert (r["dice_ce"][1] - grad).abs().max() <= F64_TOL * grad.abs().max()


def test_spatial_step_equals_the_one_process_step(spatial):
    """The spatial step on 2 processes against one process on the whole batch, f64: the loss and every parameter
    gradient (summed over the slabs) to 1e-10, the grad norm to 1e-6, on both processes, though
    the second process started from other parameters; the parameters after two AdamW updates to 1e-10 of lr."""
    reports, ref = spatial
    loss, norm, grads = ref["step"]
    for r in reports:
        got_loss, got_norm, got_grads = r["step"]
        assert abs(got_loss - loss) <= F64_TOL * loss and abs(got_norm - norm) <= 1e-6 * norm
        assert got_grads.keys() == grads.keys()
        for key, want in grads.items():
            assert (got_grads[key] - want).abs().max() <= F64_TOL * max(want.abs().max().item(), 1e-30), key
        assert abs(r["second_loss"] - ref["second_loss"]) <= F64_TOL * ref["second_loss"]
        for key, want in ref["params"].items():
            assert (r["params"][key] - want).abs().max() <= F64_TOL * OPT["lr"], key


def test_spatial_step_takes_the_first_process_batch(spatial):
    """The two processes' loaders drew different batches (seeds 0 and 1, then 2 and 3): both processes stepped on the
    first process's, the one-process step's batch, and end with the same parameters bit for bit."""
    reports, ref = spatial
    assert not torch.equal(_batch(seed=0)["image"], _batch(seed=1)["image"])
    assert reports[0]["step"][0] == reports[1]["step"][0] and reports[0]["second_loss"] == reports[1]["second_loss"]
    for key, p in reports[0]["params"].items():
        assert torch.equal(p, reports[1]["params"][key]), key


def test_one_process_step_equals_jax(jax_variables):
    """The one-process step the spatial step is held to, against JAX's ``make_train_step`` on the same bridged
    weights and batch, both in f64 (JAX under x64, the flat optimiser, lr 0): the loss to 1e-12, the grad norm to
    1e-6."""
    import jax
    import jax.numpy as jnp

    from factorizer_tpu.train import schedules as jax_schedules
    from factorizer_tpu.train import trainer as jax_trainer

    model_j, variables = jax_variables
    batch = _batch(seed=0)
    with jax.enable_x64(True):
        tx = jax_schedules.make_adamw(lr=0.0, weight_decay=0.0, warmup_steps=1, total_steps=2)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        state_j = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=v64["params"], buffers=v64["buffers"],
                                         opt_state=jax_trainer.init_opt_state(tx, v64["params"], True), tx=tx,
                                         flat_opt=True)
        step_j = jax_trainer.make_train_step(model_j, donate=False)
        _, metrics_j = step_j(state_j, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, jax.random.key(0))
        loss_j, norm_j = float(metrics_j["loss"]), float(metrics_j["grad_norm"])
    model = _model(variables).double()
    state = trainer.create_train_state(model, device="cpu", lr=0.0)
    _, metrics = trainer.make_train_step(model)(state, batch)
    assert abs(metrics["loss"].item() - loss_j) <= 1e-12 * loss_j
    assert abs(metrics["grad_norm"].item() - norm_j) <= 1e-6 * norm_j


# -- SegmentationTrainer on a data-parallel mesh


def _numpy_batch(samples: list, data: dict) -> dict:
    return {k: np.stack([data[k][i] for i in samples]) for k in ("image", "label")}


def _samples(n=10):
    rng = np.random.default_rng(5)
    return {"image": rng.standard_normal((n, 4, *SP)).astype(np.float32),
            "label": (rng.random((n, 3, *SP)) > 0.7).astype(np.uint8)}


TRAIN = dict(max_epochs=2, val_interval=2, lr=1e-3, weight_decay=1e-5, warmup_epochs=1, roi_size=SP, sw_batch_size=1,
             device="cpu")


def _trainer_worker(rank, world, init_method, root):
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    # TensorBoard's import pulls in tensorflow here (~15 s); the files it writes are gated as the history is.
    port_loop._tensorboard_writer = lambda log_dir: None
    data = _samples()
    # Process r's shard of the global batch {0, 1, 2, 3}: samples r and r + 2; its own validation case 8 + r.
    train = [_numpy_batch([rank, rank + 2], data)]
    val = [_numpy_batch([8 + rank], data)]
    report = {}

    def build(ckpt_dir, log_dir, perturb, **settings):
        model = _model()
        if perturb:  # the first process's parameters must reach the others
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        return port_loop.SegmentationTrainer(model, train, val, ckpt_dir=str(ckpt_dir), log_dir=log_dir,
                                             mesh=data_parallel_mesh(), **{**TRAIN, **settings})

    mine = Path(root) / f"rank{rank}"
    t = build(mine / "ckpt", str(mine / "log"), perturb=rank == 1)
    t.run()
    report["history"] = t.history
    report["local_val"] = t.validate()  # this process's own validation, not averaged, on the same weights
    report["params"] = {k: p.detach().clone() for k, p in t.model.named_parameters()}

    shared = Path(root) / "shared"
    build(shared, None, perturb=False).run()
    resumed = build(shared, None, perturb=rank == 1, max_epochs=3)
    resumed.initialize()
    report["resumed_at"] = resumed.state.step
    resumed.run()
    report["resumed"] = (resumed.state.step, [h["epoch"] for h in resumed.history],
                         {k: p.detach().clone() for k, p in resumed.model.named_parameters()})

    # 7 cases over 2 processes, batches of 2 under drop_last: 4 cases in 2 batches against 3 in 1.
    shard = partition_datalist([{"id": i} for i in range(7)], world, rank)
    loader = ftt.DataLoader(ftt.Dataset(shard), batch_size=2, drop_last=True, num_workers=0)
    try:
        port_loop.SegmentationTrainer(_model(), loader, mesh=data_parallel_mesh(), **TRAIN)
    except ValueError as exc:
        report["unequal"] = str(exc)
    return report


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_trainer")
    reports = run_processes(_trainer_worker, 2, str(root), timeout=300)
    data = _samples()
    one = port_loop.SegmentationTrainer(_model(), [_numpy_batch([0, 2, 1, 3], data)], None, **TRAIN)
    one.run()
    return root, reports, one


def test_trainer_trains_on_the_global_batch(trained):
    """Two processes, each loader with its block of 2 of the global batch of 4: every epoch's loss (one step each, so
    the first is the first step's) equals a one-process trainer's on the concatenated batch, rtol 1e-6 (f32, a
    mean of two means against one); the parameters after 2 epochs to atol 5e-6, as the data-parallel step's test;
    both processes end with the same parameters bit for bit, though the second started from others."""
    _, reports, one = trained
    for r in reports:
        np.testing.assert_allclose([h["loss"] for h in r["history"]], [h["loss"] for h in one.history], rtol=1e-6)
        for key, want in one.model.named_parameters():
            np.testing.assert_allclose(r["params"][key].numpy(), want.detach().numpy(), rtol=0, atol=5e-6, err_msg=key)
    for key, p in reports[0]["params"].items():
        assert torch.equal(p, reports[1]["params"][key]), key


def test_trainer_averages_validation_over_processes(trained):
    """Each process validated its own case; the history's metrics are the mean over the processes (nanmean), equal
    on both, so best-metric tracking agrees everywhere."""
    _, reports, _ = trained
    assert reports[0]["history"] == [{**h, "time_s": reports[0]["history"][i]["time_s"]}
                                     for i, h in enumerate(reports[1]["history"])]
    last = reports[0]["history"][-1]
    assert reports[0]["local_val"] != reports[1]["local_val"]
    for key, value in last.items():
        if key in reports[0]["local_val"]:
            assert value == pytest.approx(np.nanmean([r["local_val"][key] for r in reports]), abs=1e-12), key


def test_only_the_primary_writes(trained):
    """The primary process wrote ``step_2.pt`` and ``history.jsonl``; the other process, given directories of its
    own, created neither of them."""
    root, _, _ = trained
    assert (root / "rank0" / "ckpt" / "step_2.pt").is_file()
    assert len((root / "rank0" / "log" / "history.jsonl").read_text().splitlines()) == 2
    assert not (root / "rank1").exists()
    assert sorted(p.name for p in (root / "shared").iterdir() if p.name.endswith(".pt")) == ["step_3.pt"]


def test_trainer_resumes_on_every_process(trained):
    """A second trainer on the shared directory resumes at step 2 on both processes (the second one's own
    parameters perturbed first), takes the third epoch, and both end at step 3 with the same parameters."""
    _, reports, _ = trained
    for r in reports:
        assert r["resumed_at"] == 2 and r["resumed"][:2] == (3, [2])
    for key, p in reports[0]["resumed"][2].items():
        assert torch.equal(p, reports[1]["resumed"][2][key]), key


def test_unequal_shards_raise_by_name(trained):
    """7 cases on 2 processes, batches of 2 under drop_last (4 cases in 2 batches, 3 in 1): the constructor raises on
    both processes before a step, naming the shards, instead of hanging in an all-reduce without a partner."""
    _, reports, _ = trained
    for r in reports:
        assert "unequal shards" in r["unequal"] and "[(4, 2), (3, 1)]" in r["unequal"]


# -- every model family under DistributedDataParallel; the bundles' overlays on processes

FAMILIES = {  # bundle -> overrides: DynUNet's deep-supervision heads, SegResNet built late, SwinUNETR, K3, bf16
    "nnunet_brats23": {"network_def#deep_supervision": True, "network_def#deep_supr_num": 1},
    "segresnet_brats23": {},
    "swinunetr_isles22": {},
    "deconver_brats23": {},
    "factorizer_brats23": {"amp": True},
}


def _family_model(bundle):
    parser = ConfigParser(_config(bundle, **FAMILIES[bundle]))
    parser.seed(0)
    return ftt.materialize(parser["network_def"], len(parser["roi_size"])), parser


def _family_batch(parser, rank, b=1):
    cfg = parser.config["network_def"]
    shape = (cfg["in_channels"], cfg["out_channels"], *parser["roi_size"])
    return _batch(b, seed=10 + rank, dtype=np.float32, shape=shape)


def _families_worker(rank, world, init_method):
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    report = {"ddp": {}, "tp": {}}
    for bundle in FAMILIES:
        model, parser = _family_model(bundle)
        state = trainer.create_train_state(model, device="cpu", **OPT)
        step = trainer.make_train_step(model, mesh=data_parallel_mesh(), local_batch=True)
        losses = []
        for _ in range(2):  # a parameter left unused would make the second step's forward raise
            state, metrics = step(state, _family_batch(parser, rank))
            losses.append(metrics["loss"].item())
        report["ddp"][bundle] = (losses, sum(p.detach().double().sum().item() for p in model.parameters()))
    for bundle in BUNDLES:
        # The reduced widths hold no leaf of 2**14 elements: the rule's size threshold is lowered so that it cuts some.
        parser = ConfigParser(_config(bundle, "train_tp.yaml", **{"trainer#tp_min_weight_size": TP_MIN_WEIGHT_SIZE}))
        try:
            t = parser["trainer"]
        except NotImplementedError as exc:
            report["tp"][bundle] = str(exc)
            continue
        t.initialize()
        _, metrics = t.train_step(t.state, _family_batch(parser, rank, b=2))
        report["tp"][bundle] = (t._spatial_axis, metrics["loss"].item(),
                                0 if t.state.shards is None else len(t.state.shards.names))
    return report


@pytest.fixture(scope="module")
def families():
    return run_processes(_families_worker, 2, timeout=300)


@pytest.mark.parametrize("bundle", list(FAMILIES))
def test_every_model_family_steps_under_ddp(families, bundle):
    """Two processes, each with its own sample, two data-parallel steps of the bundle's reduced network_def:
    DynUNet with its deep-supervision heads in training mode, SegResNet built late (materialised before the wrap),
    SwinUNETR, the Deconver's K3 autograd function, the Factorizer in bf16 (amp: true).  No model leaves a parameter
    unused (DistributedDataParallel would raise in the second step), so no find_unused_parameters.  Both processes
    report the same losses and parameters; the first loss equals one process's on the concatenated batch (rtol
    1e-5, 2e-2 in bf16)."""
    (losses0, digest0), (losses1, digest1) = (r["ddp"][bundle] for r in families)
    assert losses0 == losses1 and digest0 == digest1 and np.isfinite(losses0).all()
    model, parser = _family_model(bundle)
    batch = {k: torch.cat([_family_batch(parser, r)[k] for r in range(2)]) for k in ("image", "label")}
    state = trainer.create_train_state(model, device="cpu", **OPT)
    _, metrics = trainer.make_train_step(model)(state, batch)
    rtol = 2e-2 if FAMILIES[bundle].get("amp") else 1e-5
    assert losses0[0] == pytest.approx(metrics["loss"].item(), rel=rtol)


@pytest.mark.parametrize("bundle", BUNDLES)
def test_train_tp_on_two_processes(families, bundle):
    """``train.yaml`` + ``train_tp.yaml`` on 2 processes (a model axis of 2): every bundle's model has a slab path,
    so each of the 12 builds the spatial step and steps on one batch alike on both processes, none raising
    ``NotImplementedError`` (SwinUNETR at its reduced roi of 32^3: slabs of 16 rows, its level 5 gathered).  The
    trainer shards its parameters by JAX's rule over the model axis (``trainer#tp_min_weight_size`` 64 at these
    widths): at least one leaf, as many on both processes, as ``tests/test_multiprocess.py`` asserts of JAX's."""
    got = [r["tp"][bundle] for r in families]
    assert not any(isinstance(g, str) for g in got), got
    assert got[0][0] == got[1][0] == "model" and got[0][1] == got[1][1] and np.isfinite(got[0][1])
    assert got[0][2] == got[1][2] >= 1


@pytest.mark.parametrize("bundle", BUNDLES)
def test_multidevice_program_builds_its_trainer_with_a_mesh(bundle):
    """``train.yaml`` + ``train_multidevice.yaml`` in one process: the trainer gets the port's
    ``data_parallel_mesh()``, a mesh of one with no group, and trains as without one; the loader's dataset is the
    whole training list (``partition_datalist`` over one process)."""
    parser = ConfigParser(_config(bundle, "train_multidevice.yaml"))
    mesh = parser["mesh"]
    assert dict(mesh.shape) == {"data": 1} and mesh.size == 1 and data_process_groups(mesh) == (1, 0)
    t = parser["trainer"]
    assert isinstance(t, ftt.SegmentationTrainer) and t.mesh is None
    assert t.train_loader.dataset.data == parser["train_datalist"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_multidevice_program_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m factorizer_tpu_torch.bundle run`` with
    ``train.yaml`` + ``train_multidevice.yaml`` at the reduced Factorizer on the CPU, 1 epoch: the CLI joins the
    group from torchrun's environment before it reads the config, each process trains on its half of the 4 training
    cases (one batch of 2), and the primary writes the one checkpoint."""
    datalist = write_cases(tmp_path, 5, ftt.save_nifti, seed=3, folds=5)
    configs = ZOO / "factorizer_brats23" / "configs"
    overrides = {**TINY_FACTORIZER, **ON_CPU, "data_dir": str(tmp_path / "data"), "datalist_path": str(datalist),
                 "num_workers": 0, "max_epochs": 1, "val_interval": 0, "output_dir": str(tmp_path / "out"),
                 "trainer#log_dir": None}
    args = [f"{k}={json.dumps(v)}" for k, v in overrides.items()]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()), "-m", "factorizer_tpu_torch.bundle", "run",
           "--config_file", str(configs / "train.yaml"), "--config_file", str(configs / "train_multidevice.yaml"), *args]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=240, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "backend gloo" in proc.stdout
    assert sorted(p.name for p in (tmp_path / "out" / "ckpt").iterdir()) == ["step_1.pt"]
