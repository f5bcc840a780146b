"""The port's SegmentationTrainer, Evaluator and EnsembleEvaluator against the JAX package's, on the CPU.

Both packages train the bundle's reduced Factorizer (roi 16^3, widths 8 / 16,
two stages, as ``tests/test_zoo.py``'s end-to-end slice) on the same synthetic
NIfTI cases through their own loaders and the bundle's transforms, which give
the same batches on one seed (``tests/test_torch_data.py``); the port's weights
start as the JAX trainer's, carried across by ``load_flax_variables``.

Tolerances (float32 on both sides; the two frameworks sum in other orders):
each epoch's mean loss to rtol 1e-4, every parameter after training to
rtol 1e-3 with atol 1e-4 of its leaf's largest entry, validation logits to
atol 1e-3 of their largest, the validation mean Dice to 1e-3.  Within the
port, a resumed run equals a straight one bit for bit.
"""

import copy
import json

import jax
import numpy as np
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu import data as jax_data
from factorizer_tpu.data import transforms as jax_T
from factorizer_tpu.train import loop as jax_loop
from factorizer_tpu.utils.torch_import import convert_state_dict

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch import data as port_data
from factorizer_tpu_torch.data import transforms as port_T
from factorizer_tpu_torch.train import loop as port_loop
from torch_workflow_cases import write_cases, yaml_transforms

torch.set_num_threads(1)

ROI = (16, 16, 16)
SW = {"head_dim": 4, "patch_size": 4, "shifts": [None, 2]}
NET = dict(in_channels=4, out_channels=3, spatial_size=ROI, encoder_depth=(1, 1), encoder_width=(8, 16),
           strides=(1, 2), decoder_depth=(1,), act="relu", rank=1, num_iters=5, init_method="uniform",
           solver="hals", mlp_ratio=4)
TRAIN = dict(lr=1e-3, weight_decay=1e-5, warmup_epochs=1, roi_size=ROI, sw_batch_size=2, overlap=0.5, seed=123)
EPOCHS = 2


def _jax_model():
    return ftx.Factorizer(**NET, reshape=(ftx.SWMatricize, SW))


def _port_model(variables=None):
    model = ftt.Factorizer(**NET, reshape=(ftt.SWMatricize, SW), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    if variables is not None:
        ftt.load_flax_variables(model, variables)
    return model


def _loaders(pkg, T, root, random_tail=True, shuffle=True):
    """The bundle's loaders over fold 0 of five cases: four to train (batch 2, two steps an epoch), one to validate.

    Without the random tail a centre crop to the roi takes its place: a resumed
    run restarts the tail's stream, so only then is it the same as a straight run.
    """
    det, aug = yaml_transforms(T, ROI)
    aug.set_random_state(7)
    items = pkg.load_decathlon_datalist(root / "datalist.json", "training", fold=0, base_dir=root / "data")
    val_items = pkg.load_decathlon_datalist(root / "datalist.json", "validation", fold=0, base_dir=root / "data")
    tail = aug.transforms if random_tail else [T.CenterSpatialCropd(["image", "label"], roi_size=ROI)]
    train = T.Compose(det.transforms + tail)
    train_loader = pkg.DataLoader(pkg.Dataset(items, train), batch_size=2, shuffle=shuffle, num_workers=0, drop_last=True)
    val_loader = pkg.DataLoader(pkg.Dataset(val_items, det), batch_size=1, num_workers=0)
    return train_loader, val_loader


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, dict(tree))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield ".".join((*prefix, k)), np.asarray(v)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("cases")
    write_cases(root, 5, ftt.save_nifti, seed=21, folds=5)  # fold 0: case0 validates, four cases train
    return root


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    """Both trainers, EPOCHS epochs with a validation at the last, from the same initial weights."""
    out = tmp_path_factory.mktemp("runs")
    train_j, val_j = _loaders(jax_data, jax_T, cases)
    trainer_j = jax_loop.SegmentationTrainer(_jax_model(), train_j, val_j, max_epochs=EPOCHS, val_interval=EPOCHS,
                                             ckpt_dir=str(out / "jax_ckpt"), **TRAIN)
    # A zero sample for the shapes: without one the JAX trainer draws a batch, and so the random tail's stream moves.
    trainer_j.initialize(sample_batch={"image": np.zeros((2, 4, *ROI), np.float32)})
    initial = {"params": _numpy_tree(trainer_j.state.params), "buffers": _numpy_tree(trainer_j.state.buffers)}
    state_j = trainer_j.run()
    train_t, val_t = _loaders(port_data, port_T, cases)
    trainer_t = port_loop.SegmentationTrainer(_port_model(initial), train_t, val_t, max_epochs=EPOCHS,
                                              val_interval=EPOCHS, ckpt_dir=str(out / "port_ckpt"), device="cpu", **TRAIN)
    state_t = trainer_t.run()
    return {"jax": (trainer_j, state_j), "port": (trainer_t, state_t), "initial": initial, "val": val_t}


def test_epoch_losses_and_history_match_jax(runs):
    """Two steps an epoch, the same history keys, each epoch's mean loss to rtol 1e-4, a validation at epoch 2."""
    (trainer_j, state_j), (trainer_t, state_t) = runs["jax"], runs["port"]
    assert state_t.step == int(state_j.step) == 2 * EPOCHS
    assert [r.keys() for r in trainer_t.history] == [r.keys() for r in trainer_j.history]
    assert set(trainer_t.history[-1]) == {"epoch", "loss", "time_s", "mean_dice", "dice_ch0", "dice_ch1", "dice_ch2"}
    losses_t = [r["loss"] for r in trainer_t.history]
    losses_j = [r["loss"] for r in trainer_j.history]
    print("losses port", losses_t, "jax", losses_j)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[1] != losses_t[0]  # the weights moved


def test_final_parameters_match_jax(runs):
    """After the four steps every parameter agrees leaf for leaf: rtol 1e-3, atol 1e-4 of the leaf's largest entry."""
    (_, state_j), (_, state_t) = runs["jax"], runs["port"]
    got = dict(_leaves(convert_state_dict(state_t.model.state_dict())["params"]))
    want = dict(_leaves(_numpy_tree(state_j.params)))
    initial = dict(_leaves(runs["initial"]["params"]))
    assert got.keys() == want.keys()
    moved = [k for k in want if not np.array_equal(want[k], initial[k])]
    assert len(moved) > len(want) // 2
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-3, atol=1e-4 * np.abs(w).max(), err_msg=key)


def test_validation_matches_jax(runs):
    """The validation's mean Dice (thresholded masks) to 1e-3, and the trained models' blended validation logits to
    atol 1e-3 of their largest."""
    (trainer_j, state_j), (trainer_t, state_t) = runs["jax"], runs["port"]
    d_t, d_j = trainer_t.history[-1]["mean_dice"], trainer_j.history[-1]["mean_dice"]
    assert 0.0 <= d_t <= 1.0
    np.testing.assert_allclose(d_t, d_j, atol=1e-3)
    (batch,) = list(runs["val"])
    logits_t = port_loop.Evaluator(state_t.model, device="cpu", roi_size=ROI).predict(batch["image"]).numpy()
    logits_j = np.asarray(jax_loop.Evaluator(trainer_j.model, state_j.variables(), roi_size=ROI).predict(batch["image"]))
    assert logits_t.shape == logits_j.shape == (1, 3, *batch["image"].shape[2:])
    np.testing.assert_allclose(logits_t, logits_j, rtol=0, atol=1e-3 * np.abs(logits_j).max())


def test_checkpoints_match_jax_steps(runs):
    """Both save after every epoch under the epoch's number, keep one, and hold the optimiser's step count."""
    (trainer_j, _), (trainer_t, state_t) = runs["jax"], runs["port"]
    assert trainer_t.ckpt.latest_step() == trainer_j.ckpt.latest_step() == EPOCHS
    assert trainer_t.ckpt.all_steps() == [EPOCHS]
    payload = trainer_t.ckpt.restore()
    assert payload["step"] == state_t.step
    for k, v in state_t.model.state_dict().items():
        assert torch.equal(payload["model"][k], v)
    assert trainer_t.ckpt.best_saved_metric("mean_dice") == trainer_t.history[-1]["mean_dice"]


def test_first_step_equals_make_train_step(cases):
    """The loop's first step is ``make_train_step`` on the loop's first batch from a copy of the same weights:
    the loss bit for bit (uint8 labels, cast on the device)."""
    train_loader, _ = _loaders(port_data, port_T, cases)
    model = _port_model()
    reference = copy.deepcopy(model)
    trainer = port_loop.SegmentationTrainer(model, train_loader, max_epochs=1, device="cpu", **TRAIN)
    seen = []
    step = trainer.train_step

    def spy(state, batch):
        if not seen:
            seen.append({k: v.clone() for k, v in batch.items()})
        state, metrics = step(state, batch)
        seen.append(metrics["loss"].clone())
        return state, metrics

    trainer.train_step = spy
    trainer.run()
    first, loss = seen[0], seen[1]
    assert first["label"].dtype == torch.uint8 and first["image"].dtype == torch.float32
    state = ftt.create_train_state(reference, device="cpu", lr=1e-3)
    _, metrics = ftt.make_train_step(state.model)(state, first)
    assert torch.equal(metrics["loss"], loss)


def test_resume_equals_straight_run(cases, tmp_path):
    """2 + 2 epochs with a resume equal 4 straight epochs bit for bit: the history's losses and every parameter.
    The resumed trainer starts at epoch 2 (step 4) with the best Dice of the first run's validation."""
    settings = dict(TRAIN, val_interval=2, max_to_keep=1)
    model = _port_model()
    start = copy.deepcopy(model.state_dict())
    train_loader, val_loader = _loaders(port_data, port_T, cases, random_tail=False)
    straight = port_loop.SegmentationTrainer(model, train_loader, val_loader, max_epochs=4,
                                             ckpt_dir=str(tmp_path / "straight"), device="cpu", **settings)
    straight.run()
    first = _port_model()
    first.load_state_dict(start)
    part = port_loop.SegmentationTrainer(first, train_loader, val_loader, max_epochs=4,
                                         ckpt_dir=str(tmp_path / "resumed"), device="cpu", **settings)
    part.max_epochs = 2  # stop after two epochs, as a run cut short would
    part.run()
    resumed = port_loop.SegmentationTrainer(_port_model(), train_loader, val_loader, max_epochs=4,
                                            ckpt_dir=str(tmp_path / "resumed"), device="cpu", **settings)
    resumed.initialize()
    assert resumed.state.step == 4 and resumed.best_metric == part.history[-1]["mean_dice"]
    resumed.run()
    assert [r["epoch"] for r in resumed.history] == [2, 3]
    losses = [r["loss"] for r in part.history + resumed.history]
    assert losses == [r["loss"] for r in straight.history]
    assert resumed.history[-1]["mean_dice"] == straight.history[-1]["mean_dice"]
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert resumed.state.step == straight.state.step == 8


def test_best_checkpoint_retention_in_the_loop(cases, tmp_path):
    """ckpt_best keeps the validated epoch with the highest mean Dice and saves no other epoch; with compute_hd95 each
    validation also reports a finite HD95 in mm, from the meta dict's affine."""
    train_loader, val_loader = _loaders(port_data, port_T, cases, random_tail=False)
    trainer = port_loop.SegmentationTrainer(_port_model(), train_loader, val_loader, max_epochs=3, ckpt_best=True,
                                            compute_hd95=True, ckpt_dir=str(tmp_path / "ckpt"), device="cpu",
                                            **dict(TRAIN, val_interval=1))
    trainer.run()
    assert all(np.isfinite(r["hd95"]) and r["hd95"] >= 0 for r in trainer.history)
    dice = [r["mean_dice"] for r in trainer.history]
    assert trainer.ckpt.all_steps() == [int(np.argmax(dice)) + 1]
    log = json.loads((tmp_path / "ckpt" / "metrics.json").read_text())
    assert [log[str(e)]["mean_dice"] for e in (1, 2, 3)] == dice
    assert trainer.best_metric == max(dice)


def test_history_file_and_timings(cases, tmp_path):
    """log_dir gets one JSON line an epoch, as the history holds it; the trainer times each epoch's loader wait."""
    train_loader, _ = _loaders(port_data, port_T, cases)
    trainer = port_loop.SegmentationTrainer(_port_model(), train_loader, max_epochs=2, log_dir=str(tmp_path / "log"),
                                            device="cpu", **TRAIN)
    trainer.run()
    lines = [json.loads(ln) for ln in (tmp_path / "log" / "history.jsonl").read_text().splitlines()]
    assert lines == trainer.history and [r["epoch"] for r in lines] == [0, 1]
    assert [t["steps"] for t in trainer.timings] == [2, 2]
    assert all(t["loader_wait_s"] > 0 and t["step_device_s"] is None for t in trainer.timings)


def test_evaluator_matches_jax(cases, tmp_path):
    """Evaluator.run with the same (untrained) weights: mean Dice and HD95 equal to JAX's within 1e-3 relative, the
    per-case file written with one entry per case."""
    initial = _initial_variables(seed=0)
    _, val_t = _loaders(port_data, port_T, cases)
    _, val_j = _loaders(jax_data, jax_T, cases)
    got = port_loop.Evaluator(_port_model(), _port_model(initial).state_dict(), roi_size=ROI, device="cpu").run(
        val_t, save_case_metrics=str(tmp_path / "cases.json"))
    want = jax_loop.Evaluator(_jax_model(), initial, roi_size=ROI).run(val_j)
    assert set(got) == set(want) == {"mean_dice", "hd95"}
    np.testing.assert_allclose(got["mean_dice"], want["mean_dice"], rtol=1e-3)
    np.testing.assert_allclose(got["hd95"], want["hd95"], rtol=1e-3)
    per_case = json.loads((tmp_path / "cases.json").read_text())
    assert [c["id"] for c in per_case] == ["case0"] and 0.0 <= per_case[0]["dice"] <= 1.0


def _initial_variables(seed):
    variables = jax.jit(_jax_model().init)(jax.random.key(seed), jax.numpy.zeros((1, 4, *ROI)))
    return {"params": _numpy_tree(variables["params"]), "buffers": _numpy_tree(variables["buffers"])}


def test_ensemble_matches_jax(cases):
    """EnsembleEvaluator over two fold weight sets (the port's as checkpoints would hold them): the mean sigmoid
    equals JAX's to atol 1e-5, and leaves the shared model's own weights alone."""
    folds = [_initial_variables(seed) for seed in (1, 2)]
    _, val_t = _loaders(port_data, port_T, cases)
    (batch,) = list(val_t)
    model = _port_model()
    own = copy.deepcopy(model.state_dict())
    fold_states = [{"step": 0, "model": _port_model(v).state_dict(), "optimizer": {}} for v in folds]
    got = port_loop.EnsembleEvaluator(model, fold_states, roi_size=ROI, device="cpu").predict(batch["image"])
    want = jax_loop.EnsembleEvaluator(_jax_model(), folds, roi_size=ROI).predict(batch["image"])
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert all(torch.equal(v, own[k]) for k, v in model.state_dict().items())


def test_entry_points_default_to_the_card(cases):
    """device=None means the card: without one, the trainer and the evaluators raise instead of running on the CPU."""
    assert not torch.cuda.is_available()
    train_loader, _ = _loaders(port_data, port_T, cases)
    for build in (lambda: port_loop.SegmentationTrainer(_port_model(), train_loader),
                  lambda: port_loop.Evaluator(_port_model()),
                  lambda: port_loop.EnsembleEvaluator(_port_model(), [None])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


@pytest.mark.parametrize("name,value", [("mesh", object()), ("model_axis", "model"), ("shard_spatial", True),
                                        ("tp_min_weight_size", 1)])
def test_sharded_training_arguments_raise(cases, name, value):
    """The JAX trainer's sharding arguments in one process: a ``mesh`` that is not a ``parallel.Mesh`` raises by name;
    ``model_axis``, ``shard_spatial`` and ``tp_min_weight_size`` without a mesh of more than one process are taken
    as JAX takes them, as the plain step (no model axis above size 1, so no spatial step); the bundles' ``mesh:
    null`` and a mesh of one process are accepted.  (``tests/test_torch_multidevice.py`` runs them on processes.)"""
    train_loader, _ = _loaders(port_data, port_T, cases)
    if name == "mesh":
        with pytest.raises(TypeError, match="mesh"):
            port_loop.SegmentationTrainer(_port_model(), train_loader, device="cpu", mesh=value)
    else:
        trainer = port_loop.SegmentationTrainer(_port_model(), train_loader, device="cpu", **{name: value})
        assert trainer.mesh is None and trainer._spatial_axis is None
    port_loop.SegmentationTrainer(_port_model(), train_loader, device="cpu", mesh=None)
    settings = {"model_axis": "model", "shard_spatial": True, **({name: value} if name != "mesh" else {})}
    one = port_loop.SegmentationTrainer(_port_model(), train_loader, device="cpu", mesh=ftt.model_parallel_mesh(),
                                        **settings)
    assert one.mesh is None and one._spatial_axis is None
