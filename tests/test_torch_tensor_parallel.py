"""Weight sharding over the model axis: JAX's ``param_sharding_rules`` in the port's train state.

``create_train_state(model, mesh=, model_axis=, min_weight_size=)`` (and
``SegmentationTrainer(model_axis=, tp_min_weight_size=)``, which
``train_tp.yaml`` sets) holds each parameter that JAX's ``param_leaf_rule``
cuts over ``model`` as this process's half of it, with its AdamW moments;
the step gathers the whole weights for the forward and the backward.  Held
here:

* (a) the rule, leaf for leaf, against JAX's on the JAX leaf behind each
  port parameter (the bridge's path; shapes from ``jax.eval_shape``) for
  seven model families at ``n`` = 2 and 3 and ``min_weight_size`` 64 and
  2**14: UNETR's attention kernels are judged on ``(in, heads, head_dim)``,
  not on the port's folded ``(out, in)``;
* (b) the sharded spatial step on 2 gloo processes, f64, two AdamW steps of
  a reduced Factorizer (K5's plain passes, K2's plain version on gathered
  MLP weights) and a Deconver: loss, grad norm and every gathered parameter
  and moment against the whole-weight 2-process step and one process, to
  1e-10 of the largest; each sharded leaf's parameter and moments hold half
  of it on each process, and the model's own parameters of them nothing;
* (c) ``model_axis`` without the spatial step (the trainer's
  ``shard_spatial: false``, which raised before) against one process;
* (d) the port's sharded step against JAX's ``make_train_step`` on 2 XLA CPU
  devices with parameters placed by ``param_sharding_rules(...,
  min_weight_size=64)`` and ``spatial_axis="model"``, f64: loss and every
  gradient to 1e-10; both sides shard the same leaves;
* (e) ``SegmentationTrainer`` checkpoints: the sharded run's file equals the
  whole-weight run's key for key (model and AdamW state); a one-process
  trainer resumes from it, and a sharded trainer from a one-process file,
  with the next epoch's loss of the one-process run;
* (f) validation on loaders of 1 and 2 volumes on the two processes finishes
  (the weights are gathered once per validation, not per forward);
* (g) ``grad_clip_norm`` on the shards: the gradients left after the step
  equal the whole step's clipped ones.

One spawn of 2 processes serves (b)-(g); the workers are module-level
functions run by ``parallel.run_processes``.
"""

import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.parallel import Mesh, initialize_distributed, model_parallel_mesh, run_processes
from factorizer_tpu_torch.parallel.sharding import param_sharding_rules
from factorizer_tpu_torch.train import loop as port_loop
from factorizer_tpu_torch.train import trainer
from factorizer_tpu_torch.train.checkpoint import restore_checkpoint
from factorizer_tpu_torch.utils.weights import flax_leaf_paths, flax_state_dict

torch.set_num_threads(1)

F64_TOL = 1e-10
WORLD = 2
OPT = dict(lr=1e-2, weight_decay=1e-2)
MIN = 64
WHOLE = 2**62  # above every leaf: nothing sharded
CLIP = 0.05
SP = (32, 8, 8)
FACTORIZER = dict(in_channels=4, out_channels=3, spatial_size=SP, encoder_depth=(1, 1), encoder_width=(8, 16),
                  strides=(1, 2), decoder_depth=(1,), mlp_ratio=4, act="relu", rank=1, num_iters=5,
                  init_method="uniform", solver="hals")
SW = {"head_dim": 4, "patch_size": 4, "shifts": [None, 1, 2, 3]}
DECONVER = dict(in_channels=4, out_channels=3, spatial_dims=3, kernel_size=(3, 3, 3), encoder_depth=(1, 1),
                encoder_width=(8, 16), strides=(1, 2), decoder_depth=(1,), act="relu", groups=-1, ratio=1, num_iters=2)
# The reduced DynUNet that JAX's sharded GSPMD step and the port's sharded 2-slab step both run (d).
JAX_DYNUNET = dict(in_channels=2, out_channels=3, kernel_size=(3, 3), strides=(1, 2), filters=(4, 8))
JAX_SHAPE = (2, 2, 16, 8, 8)


def _gen():
    return torch.Generator().manual_seed(1)


# -- (a) the rule against JAX's, family by family

# name -> (model from a library (ftx or ftt) and its keywords, input shape[, the JAX init's keywords])
FAMILIES = {
    "factorizer": (lambda lib, kw: lib.Factorizer(**FACTORIZER, reshape=(lib.SWMatricize, SW), **kw), (1, 4, *SP)),
    "deconver": (lambda lib, kw: lib.Deconver(**DECONVER, norm=lib.InstanceNorm, **kw), (1, 4, 16, 8, 8)),
    "unet": (lambda lib, kw: lib.UNet(4, 3, encoder_depth=(1, 1), encoder_width=(8, 16), strides=(1, 2),
                                      decoder_depth=(1,), stem=(lib.Conv, {"kernel_size": 3, "padding": 1}),
                                      block=lib.DoubleConv, **kw), (1, 4, 16, 8, 8)),
    "dynunet": (lambda lib, kw: lib.DynUNet(2, 3, kernel_size=(3, 3, 3), strides=(1, 2, 2), filters=(8, 16, 24),
                                            deep_supervision=True, deep_supr_num=1, **kw), (1, 2, 16, 16, 16),
                {"train": True}),
    "segresnet": (lambda lib, kw: lib.SegResNet(2, 3, init_filters=8, blocks_down=(1, 2, 2), blocks_up=(1, 1), **kw),
                  (1, 2, 16, 16, 16)),
    "swinunetr": (lambda lib, kw: lib.SwinUNETR(2, 3, img_size=(32, 32, 32), feature_size=12, depths=(1, 1, 1, 1),
                                                num_heads=(2, 2, 2, 2), window_size=4, **kw), (1, 2, 32, 32, 32)),
    # 3 heads of 8: at n = 3 JAX keeps query / key / value (last axis head_dim 8) whole, though 3 divides 24
    "unetr": (lambda lib, kw: lib.UNETR(2, 3, img_size=(32, 32, 32), feature_size=8, hidden_size=24, mlp_dim=48,
                                        num_heads=3, num_layers=2, patch_size=16, **kw), (1, 2, 32, 32, 32)),
}
_SIDES = {}


def _sides(name):
    """The port model (built on the CPU) and the shapes of the JAX model's parameters, by ``jax.eval_shape``."""
    if name not in _SIDES:
        import jax
        import jax.numpy as jnp

        import factorizer_tpu as ftx

        make, shape, *init = FAMILIES[name]
        model_j = make(ftx, {})
        shapes = jax.eval_shape(lambda x: model_j.init(jax.random.key(0), x, **(init or [{}])[0]), jnp.zeros(shape))
        _SIDES[name] = ftt.materialize(make(ftt, {"device": "cpu", "generator": _gen()}), len(shape) - 2), shapes
    return _SIDES[name]


def _mesh_of(n: int) -> Mesh:
    """A mesh of ``n`` processes along ``model`` as this process sees it: the rule reads its shape alone."""
    return Mesh(shape={"data": 1, "model": n}, coords={"data": 0, "model": 0},
                axis_ranks={"data": (0,), "model": tuple(range(n))}, groups={"data": None, "model": None})


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("min_weight_size", [64, 2**14])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_rule_matches_jax(name, n, min_weight_size):
    """The port parameters that ``param_sharding_rules`` cuts are exactly those whose Flax leaf (by the bridge's path)
    JAX's ``param_leaf_rule`` maps to a spec naming ``model``, on its last axis; every Flax parameter that JAX cuts
    has a port parameter.  At 64 every family cuts some leaf at ``n`` = 2."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from factorizer_tpu.parallel.sharding import param_leaf_rule

    model, shapes = _sides(name)
    rule = param_leaf_rule(JaxMesh(np.array(jax.devices()[:n]).reshape(1, n), ("data", "model")), "model",
                           min_weight_size)
    got = param_sharding_rules(model, _mesh_of(n), "model", min_weight_size)
    paths = flax_leaf_paths(model)
    assert set(got) == {k for k, _ in model.named_parameters()}
    cut_by_jax = set()
    for key, axis in got.items():
        collection, path, _ = paths[key]
        assert collection == "params", key
        spec = rule(_get(shapes[collection], path)).spec
        want = "model" if "model" in tuple(spec) else None
        assert axis == want, (key, path, spec)
        assert want is None or tuple(spec)[-1] == "model"
        if want:
            cut_by_jax.add(path)
    every = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    for keys, leaf in every:
        path = tuple(k.key for k in keys)
        if "model" in tuple(rule(leaf).spec):
            assert path in cut_by_jax, path
    if min_weight_size == 64 and n == 2:
        assert any(got.values())
    if name == "unetr" and n == 3 and min_weight_size == 64:
        query = next(k for k in got if k.endswith("attn.query.weight"))
        assert got[query] is None and dict(model.named_parameters())[query].shape[0] % 3 == 0


# -- (b)-(g): one spawn of 2 processes


def _model(name):
    if name == "factorizer":
        return ftt.Factorizer(**FACTORIZER, reshape=(ftt.SWMatricize, SW), device="cpu", generator=_gen()).double()
    return ftt.Deconver(**DECONVER, norm=ftt.InstanceNorm, device="cpu", generator=_gen()).double()


def _batch(c_in, c_out, size, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.standard_normal((b, c_in, *size))),
            "label": torch.from_numpy((rng.random((b, c_out, *size)) > 0.7).astype(np.float64))}


BATCHES = {"factorizer": (4, 3, SP), "deconver": (4, 3, (16, 8, 8))}


def _whole_grads(state) -> dict:
    """The step's gradient left in the state, whole: the shards' gathered (collective where sharded)."""
    grads = {k: p.grad.clone() for k, p in state.model.named_parameters() if p.grad is not None}
    sh = state.shards
    if sh is not None:
        grads.update(zip(sh.names, sh.gather_flat(sh.pack([s.grad for s in sh.shards]))))
    return grads


def _steps(name, mesh=None, min_weight_size=WHOLE, spatial=True, clip=None, lr_settings=OPT) -> dict:
    """Two AdamW steps of ``name``: on 2 processes (``mesh``) over the model axis, on slabs or (``spatial=False``) each
    the whole batch; the losses, grad norms, the first step's whole gradient, the whole state after, and what each
    process holds of every sharded leaf."""
    model = _model(name)
    state = trainer.create_train_state(model, device="cpu", grad_clip_norm=clip, mesh=mesh, model_axis="model",
                                       min_weight_size=min_weight_size, **lr_settings)
    axes = {} if mesh is None else {"spatial_axis": "model"} if spatial else {"model_axis": "model"}
    step = trainer.make_train_step(model, mesh=mesh, **axes)
    report = {"losses": [], "norms": []}
    for i in range(2):
        state, metrics = step(state, _batch(*BATCHES[name], seed=i))
        report["losses"].append(metrics["loss"].item())
        report["norms"].append(metrics["grad_norm"].item())
        if i == 0:
            report["grads"] = _whole_grads(state)
    sh = state.shards
    if sh is not None:
        moments = state.optimizer.state
        report["held"] = {k: (p.numel(), s.numel(), moments[s]["exp_avg"].numel(), moments[s]["exp_avg_sq"].numel(),
                              int(np.prod(shape)))
                          for k, p, s, shape in zip(sh.names, sh.params, sh.shards, sh.shapes)}
    report["bytes"] = trainer.state_bytes(state)
    report["state"] = state.state_dict()
    return report


def _jax_dynunet(mesh, variables) -> dict:
    """The reduced DynUNet with the JAX model's weights, one sharded spatial step at lr 0: loss, gradients, the
    sharded leaves."""
    model = ftt.DynUNet(**JAX_DYNUNET, device="cpu").double()
    ftt.load_flax_variables(model, variables)
    batch = _batch(JAX_SHAPE[1], 3, JAX_SHAPE[2:], b=JAX_SHAPE[0], seed=9)
    state = trainer.create_train_state(model, device="cpu", lr=0.0, mesh=mesh, model_axis="model",
                                       min_weight_size=MIN)
    state, metrics = trainer.make_train_step(model, mesh=mesh, spatial_axis="model")(state, batch)
    return {"loss": metrics["loss"].item(), "grads": _whole_grads(state), "sharded": list(state.shards.names)}


def _numpy_batch(seed, b=2) -> dict:
    batch = _batch(*BATCHES["factorizer"], b=b, seed=seed)
    return {"image": batch["image"].numpy(), "label": batch["label"].numpy().astype(np.uint8)}


TRAIN_DATA = [_numpy_batch(20), _numpy_batch(21)]
TRAIN = dict(val_interval=1, lr=1e-2, weight_decay=1e-2, warmup_epochs=1, roi_size=SP, sw_batch_size=1, device="cpu")


def _trainer(ckpt_dir, max_epochs, mesh=None, val=None, **settings):
    return port_loop.SegmentationTrainer(_model("factorizer"), TRAIN_DATA, val, ckpt_dir=str(ckpt_dir),
                                         max_epochs=max_epochs, mesh=mesh, **{**TRAIN, **settings})


def _worker(rank, world, init_method, root, variables):
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    port_loop._tensorboard_writer = lambda log_dir: None
    mesh = model_parallel_mesh()
    report = {}
    for name in BATCHES:
        report[name] = {"sharded": _steps(name, mesh, MIN), "whole": _steps(name, mesh)}
    report["model_axis"] = _steps("factorizer", mesh, MIN, spatial=False)
    report["clip"] = _steps("factorizer", mesh, MIN, clip=CLIP)
    report["jax"] = _jax_dynunet(mesh, variables)

    # (e), (f): one epoch sharded and whole-weight, validating 1 and 2 volumes; then a sharded resume of the
    # one-process file.
    val = [_numpy_batch(30 + i, b=1) for i in range(rank + 1)]
    tp = dict(model_axis="model", shard_spatial=True)
    trainers = {}
    for label, size in (("sharded", MIN), ("whole", WHOLE)):
        t = _trainer(root / label, 1, mesh, val, tp_min_weight_size=size, **tp)
        t.run()
        trainers[label] = t
    report["history"] = trainers["sharded"].history
    report["sharded_leaves"] = list(trainers["sharded"].state.shards.names)
    assert trainers["whole"].state.shards is None
    if rank == 0:
        shutil.copytree(root / "one", root / "resume_sharded")
    dist.barrier()
    t = _trainer(root / "resume_sharded", 2, mesh, tp_min_weight_size=MIN, **tp)
    t.initialize()
    report["resumed_at"] = t.state.step
    # Each shard's moments hold their own storage: no view keeps the file's whole moment alive.
    moments = t.state.optimizer.state
    report["resumed_moments"] = [moments[s][m].untyped_storage().nbytes() == s.numel() * s.element_size()
                                 for s in t.state.shards.shards for m in ("exp_avg", "exp_avg_sq")]
    t.run()
    report["resumed_loss"] = t.history[-1]["loss"]
    return report


def _jax_variables() -> dict:
    """Variables of the JAX model's structure (``jax.eval_shape``, no compile), drawn with numpy from a seed."""
    import jax
    import jax.numpy as jnp

    import factorizer_tpu as ftx

    shapes = jax.eval_shape(ftx.DynUNet(**JAX_DYNUNET).init, jax.random.key(3), jnp.zeros((1, *JAX_SHAPE[1:])))
    rng = np.random.default_rng(3)
    return jax.tree.map(lambda s: 0.3 * rng.standard_normal(s.shape).astype(np.float32), dict(shapes))


@pytest.fixture(scope="module")
def jax_variables():
    return _jax_variables()


@pytest.fixture(scope="module")
def run(jax_variables, tmp_path_factory):
    """The two processes' reports, the one-process references, and the checkpoint directories."""
    root = tmp_path_factory.mktemp("tp")
    _trainer(root / "one", 1).run()  # the one-process file that a sharded trainer resumes from
    reports = run_processes(_worker, WORLD, root, jax_variables, timeout=300)
    one = {name: _steps(name) for name in BATCHES}
    one["clip"] = _steps("factorizer", clip=CLIP)
    return reports, one, root


def _close(a: torch.Tensor, b: torch.Tensor, scale: float, what) -> None:
    assert a.shape == b.shape and (a - b).abs().max().item() <= F64_TOL * scale, what


def _states_close(got: dict, want: dict) -> None:
    """Two whole ``{"step", "model", "optimizer"}`` dicts key for key, tensors to 1e-10 of each kind's largest."""
    assert got["step"] == want["step"] and got["model"].keys() == want["model"].keys()
    largest = max(v.abs().max().item() for v in want["model"].values())
    for key, v in want["model"].items():
        _close(got["model"][key], v, largest, key)
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
    assert got["optimizer"]["state"].keys() == want["optimizer"]["state"].keys()
    for moment in ("exp_avg", "exp_avg_sq"):
        largest = max(s[moment].abs().max().item() for s in want["optimizer"]["state"].values())
        for i, s in want["optimizer"]["state"].items():
            _close(got["optimizer"]["state"][i][moment], s[moment], largest, (i, moment))
            assert got["optimizer"]["state"][i]["step"] == s["step"]


def _steps_close(got: dict, want: dict) -> None:
    for a, b in zip(got["losses"] + got["norms"], want["losses"] + want["norms"]):
        assert abs(a - b) <= F64_TOL * abs(b)
    largest = max(g.abs().max().item() for g in want["grads"].values())
    assert got["grads"].keys() == want["grads"].keys()
    for key, g in want["grads"].items():
        _close(got["grads"][key], g, largest, key)
    _states_close(got["state"], want["state"])


@pytest.mark.parametrize("name", list(BATCHES))
def test_sharded_spatial_step_equals_whole_and_one_process(run, name):
    """Two sharded AdamW steps on 2 slabs, f64: loss, grad norm, the first step's gradient and the whole parameters
    and moments after (gathered) as the whole-weight 2-process step's and one process's, to 1e-10 of the largest;
    between steps each sharded leaf's parameter and both moments hold half of it on each process and the model's
    parameter nothing; the bytes of parameters and moments a process holds (``trainer.state_bytes``) fall by three
    halves of those leaves (parameter, ``exp_avg``, ``exp_avg_sq``) from the whole-weight step's."""
    reports, one, _ = run
    for r in reports:
        got, whole = r[name]["sharded"], r[name]["whole"]
        _steps_close(got, one[name])
        _steps_close(whole, one[name])
        assert got["held"]
        for key, (model_numel, shard, exp_avg, exp_avg_sq, numel) in got["held"].items():
            assert model_numel == 0 and shard == exp_avg == exp_avg_sq == numel // 2, key
        halves = sum(numel // 2 for *_, numel in got["held"].values())
        assert whole["bytes"] == one[name]["bytes"] and got["bytes"] == whole["bytes"] - 3 * 8 * halves


def test_model_axis_without_spatial_equals_one_process(run):
    """``model_axis`` without the spatial step: both processes of the line run the whole model on the first one's
    batch and keep their half of the same gradient (no sum over the line); two steps as one process's to 1e-10."""
    reports, one, _ = run
    for r in reports:
        _steps_close(r["model_axis"], one["factorizer"])
        assert r["model_axis"]["held"]


def test_sharded_step_agrees_with_jax_tensor_parallel(run, jax_variables):
    """JAX's ``make_train_step(mesh, spatial_axis="model")`` on 2 XLA CPU devices, parameters placed by
    ``param_sharding_rules(..., min_weight_size=64)`` (so XLA runs them sharded), against the port's sharded 2-slab
    step, f64: loss to 1e-10 and every gradient to 1e-10 of the largest; both shard the same leaves."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh as JaxMesh

    import factorizer_tpu as ftx
    from factorizer_tpu.parallel.sharding import param_sharding_rules as jax_rules
    from factorizer_tpu.parallel.sharding import shard_variables
    from factorizer_tpu.train import trainer as jax_trainer

    batch = _batch(JAX_SHAPE[1], 3, JAX_SHAPE[2:], b=JAX_SHAPE[0], seed=9)
    with jax.enable_x64(True):
        mesh = JaxMesh(np.array(jax.devices()[:WORLD]).reshape(1, WORLD), ("data", "model"))
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jax_variables["params"])
        params = shard_variables(params, jax_rules(params, mesh, min_weight_size=MIN))
        leaves = jax.tree_util.tree_flatten_with_path(params)[0]
        cut = {tuple(k.key for k in keys) for keys, a in leaves if "model" in tuple(a.sharding.spec)}
        assert cut  # XLA really runs some leaves sharded
        tx = optax.scale(1.0)
        state = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32), params=params, buffers={},
                                       opt_state=jax_trainer.init_opt_state(tx, params, False), tx=tx, flat_opt=False)
        step = jax_trainer.make_train_step(ftx.DynUNet(**JAX_DYNUNET), mesh=mesh, spatial_axis="model", donate=False)
        new, metrics = step(state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, jax.random.key(0))
        grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), new.params, params)
        loss = float(metrics["loss"])
    model = ftt.DynUNet(**JAX_DYNUNET, device="cpu").double()
    want = flax_state_dict(model, {"params": grads})
    paths = flax_leaf_paths(model)
    reports = run[0]
    largest = max(np.abs(want[k].numpy()).max() for k in reports[0]["jax"]["grads"])
    for r in reports:
        port = r["jax"]
        assert {paths[k][1] for k in port["sharded"]} == cut
        assert abs(port["loss"] - loss) <= F64_TOL * abs(loss)
        for key, g in port["grads"].items():
            assert np.abs(g.numpy() - want[key].numpy()).max() <= F64_TOL * largest, key


def test_checkpoints_are_whole_and_resume_both_ways(run):
    """``SegmentationTrainer`` with ``model_axis``, ``shard_spatial`` and ``tp_min_weight_size=64``, one epoch of 2
    steps: its checkpoint (gathered on both processes, written by the primary) equals the whole-weight run's key for
    key, model and AdamW state, in the one-process format (it loads into a one-process ``state_dict``).  A
    one-process trainer resumes from it, and a sharded trainer from a one-process file, at step 2, each shard's
    moments in storage of their own size; the next epoch's loss equals the one-process run's own resume to 1e-10."""
    reports, _, root = run
    sharded = restore_checkpoint(root / "sharded" / "step_1.pt")
    whole = restore_checkpoint(root / "whole" / "step_1.pt")
    alone = restore_checkpoint(root / "one" / "step_1.pt")
    _states_close(sharded, whole)
    _states_close(sharded, alone)
    assert reports[0]["sharded_leaves"] and sharded["step"] == 2
    _model("factorizer").load_state_dict(sharded["model"])

    shutil.copytree(root / "sharded", root / "resume_one")
    shutil.copytree(root / "one", root / "resume_alone")
    resumed = {}
    for label in ("resume_one", "resume_alone"):
        t = _trainer(root / label, 2)
        t.initialize()
        assert t.state.step == 2
        t.run()
        resumed[label] = t.history[-1]["loss"]
    for value in (resumed["resume_one"], *(r["resumed_loss"] for r in reports)):
        assert abs(value - resumed["resume_alone"]) <= F64_TOL * abs(resumed["resume_alone"])
    assert all(r["resumed_at"] == 2 and r["resumed_moments"] and all(r["resumed_moments"]) for r in reports)


def test_validation_with_unequal_loaders_finishes(run):
    """The sharded trainer validated 1 volume on one process and 2 on the other after its epoch (the weights gathered
    once on each, before ``validate()``): the spawn returned, and both processes log the same mean over the
    processes."""
    reports, _, _ = run
    a, b = ({k: v for k, v in r["history"][-1].items() if k != "time_s"} for r in reports)
    assert "mean_dice" in a and a == b and np.isfinite(a["loss"])


def test_clipping_on_shards_equals_the_whole_step(run):
    """``grad_clip_norm`` below the gradient's norm: the norm is the whole step's (the shards' squares summed over the
    axis, the whole leaves counted once), the clipped gradient left after the step and the parameters after two
    steps as one process's, to 1e-10."""
    reports, one, _ = run
    assert one["clip"]["norms"][0] > CLIP
    for r in reports:
        _steps_close(r["clip"], one["clip"])
