"""The port's multi-device layer on gloo processes: mesh, ring exchange, batch sharding, the data-parallel train step.

Counterpart of what ``tests/test_parallel.py`` and ``tests/test_multiprocess.py``
check of ``factorizer_tpu/parallel``.  The workers are spawned processes that
import this module, so jax is imported inside the tests that need it, never
at the top.  The one-process train step that the data-parallel step is held
to is pinned to JAX's by ``tests/test_torch_trainer.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.parallel import (
    child_processes,
    data_parallel_mesh,
    data_process_groups,
    initialize_distributed,
    make_mesh,
    model_parallel_mesh,
    process_is_primary,
    ring_exchange,
    run_processes,
    shard_batch,
)
from factorizer_tpu_torch.parallel.slabs import Cut
from factorizer_tpu_torch.train import trainer

torch.set_num_threads(1)

SP = (16, 16, 16)
CONFIG = dict(  # the reduced Factorizer of tests/test_torch_trainer.py
    in_channels=4, out_channels=3, spatial_size=SP, encoder_depth=(1, 1, 1), encoder_width=(8, 16, 16),
    strides=(1, 2, 2), decoder_depth=(1, 1), mlp_ratio=4, act="relu", rank=1, num_iters=5, init_method="uniform",
    solver="hals",
)
SW = {"head_dim": 4, "patch_size": 4, "shifts": [None, 1, 2, 3]}
OPT = dict(lr=1e-3, weight_decay=1e-2)
STEPS = 2


def _model():
    return ftt.Factorizer(**CONFIG, reshape=(ftt.SWMatricize, SW), device="cpu", generator=torch.Generator().manual_seed(1))


def _batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.standard_normal((b, 4, *SP)).astype(np.float32)),
            "label": torch.from_numpy((rng.random((b, 3, *SP)) > 0.7).astype(np.float32))}


def _mesh_worker(rank, world, init_method):
    """What this process sees of a {data 2, model 2} mesh; sums and rings over each axis's group."""
    torch.set_num_threads(1)
    backend = initialize_distributed(init_method, world, rank)
    mesh = make_mesh({"data": 2, "model": -1})
    report = {"backend": backend, "primary": process_is_primary(), "shape": dict(mesh.shape), "coords": dict(mesh.coords),
              "axis_ranks": dict(mesh.axis_ranks), "names": mesh.axis_names}
    for axis in mesh.axis_names:
        total = torch.tensor([float(rank)])
        dist.all_reduce(total, group=mesh.group(axis))
        report[f"sum_{axis}"] = total.item()
        mine = torch.full((2, 3), float(rank))
        report[f"from_previous_{axis}"] = ring_exchange(mine, mesh, axis, forward=True)[0, 0].item()
        report[f"from_next_{axis}"] = ring_exchange(mine, mesh, axis, forward=False)[0, 0].item()
    batch = {"image": torch.arange(4 * 2 * 8 * 2 * 2, dtype=torch.float32).reshape(4, 2, 8, 2, 2)}
    report["shard_data"] = shard_batch(batch, mesh)["image"]
    report["shard_both"] = shard_batch(batch, mesh, spatial_axis="model")["image"]
    report["shard_no_axis"] = shard_batch(batch["image"], mesh, data_axis="rows").shape
    with pytest.raises(ValueError, match="equal shards"):
        shard_batch(torch.zeros(3, 1, 4), mesh)
    with pytest.raises(ValueError, match="needs 6 processes, the group has 4"):
        make_mesh({"data": 2, "model": 3})
    with pytest.raises(ValueError, match="not 'rows'"):
        mesh.axis_size("rows")
    flat = data_parallel_mesh()
    report["flat"] = (dict(flat.shape), flat.axis_index("data"), flat.axis_ranks["data"])
    across, local = model_parallel_mesh(), model_parallel_mesh(data=2, model=2, model_across_processes=False)
    report["layouts"] = {"data_parallel": data_process_groups(flat),
                         "model_across": (dict(across.shape), dict(across.coords), data_process_groups(across)),
                         "model_local": (dict(local.shape), dict(local.coords), data_process_groups(local))}
    with pytest.raises(ValueError, match="model_across_processes"):
        model_parallel_mesh(data=2, model=2)
    with pytest.raises(ValueError, match="a 3 x 2 mesh over 4"):
        model_parallel_mesh(data=3, model=2, model_across_processes=False)
    # The spatial step on {data 2, model 2}: each data line's 2 samples of the whole batch of 4, on 2 slabs each.
    model = _model().double()
    state = trainer.create_train_state(model, device="cpu", **OPT)
    step = trainer.make_train_step(model, mesh=local, spatial_axis="model")
    state, m = step(state, {k: v.double() for k, v in _batch(seed=9).items()})
    report["spatial_step"] = (m["loss"].item(), {k: q.grad.clone() for k, q in model.named_parameters()})
    return report


@pytest.fixture(scope="module")
def mesh_reports():
    return run_processes(_mesh_worker, 4, timeout=120)


def test_make_mesh_axes_and_indices(mesh_reports):
    """Four processes as {data 2, model 2}: sizes, this process's index per axis (the last axis varies fastest, as a
    reshape of JAX's device list), the ranks of its lines; -1 absorbs the rest; ``data_parallel_mesh`` is one axis."""
    for rank, r in enumerate(mesh_reports):
        assert r["backend"] == "gloo" and r["primary"] == (rank == 0)
        assert r["shape"] == {"data": 2, "model": 2} and r["names"] == ("data", "model")
        assert r["coords"] == {"data": rank // 2, "model": rank % 2}
        assert r["axis_ranks"] == {"data": (rank % 2, rank % 2 + 2), "model": (rank // 2 * 2, rank // 2 * 2 + 1)}
        assert r["flat"] == ({"data": 4}, rank, (0, 1, 2, 3))


def test_mesh_layouts_and_loader_groups(mesh_reports):
    """The layouts JAX's docstrings name, on four processes: pure data parallelism loads a partition per process
    (``data_process_groups`` = ``(4, rank)``); ``model_parallel_mesh()`` puts all four on one ``model`` line, one
    loader group ``(1, 0)``; with ``model_across_processes=False`` and ``{data 2, model 2}`` the data index varies
    slowest, two loader groups of two.  Layouts that do not fit the processes raise."""
    for rank, r in enumerate(mesh_reports):
        layouts = r["layouts"]
        assert layouts["data_parallel"] == (4, rank)
        assert layouts["model_across"] == ({"data": 1, "model": 4}, {"data": 0, "model": rank}, (1, 0))
        assert layouts["model_local"] == ({"data": 2, "model": 2}, {"data": rank // 2, "model": rank % 2}, (2, rank // 2))


def test_spatial_step_on_a_data_and_model_mesh(mesh_reports):
    """The spatial step on ``{data 2, model 2}`` with the whole batch of 4 on every process, f64: each data line takes
    its 2 samples on 2 slabs; gradients summed over ``model`` and averaged over ``data`` equal the one-process step's
    on the 4 samples to 1e-10, as does the loss, on all four processes."""
    model = _model().double()
    state = trainer.create_train_state(model, device="cpu", **OPT)
    state, m = trainer.make_train_step(model)(state, {k: v.double() for k, v in _batch(seed=9).items()})
    for r in mesh_reports:
        loss, grads = r["spatial_step"]
        assert abs(loss - m["loss"].item()) <= 1e-10 * m["loss"].item()
        for key, q in model.named_parameters():
            assert (grads[key] - q.grad).abs().max() <= 1e-10 * q.grad.abs().max(), key


def test_mesh_groups_reduce_over_their_line(mesh_reports):
    """An all-reduce over an axis's group sums exactly the ranks of that line."""
    for rank, r in enumerate(mesh_reports):
        assert r["sum_data"] == sum(r["axis_ranks"]["data"]) and r["sum_model"] == sum(r["axis_ranks"]["model"])


def test_ring_exchange_directions(mesh_reports):
    """Forward sends to the next index and receives from the previous; in a ring of two both are the other process."""
    for rank, r in enumerate(mesh_reports):
        for axis in ("data", "model"):
            other = [q for q in r["axis_ranks"][axis] if q != rank][0]
            assert r[f"from_previous_{axis}"] == other and r[f"from_next_{axis}"] == other


def test_shard_batch_cuts_batch_and_rows(mesh_reports):
    """``shard_batch`` cuts the batch over ``data`` and, when asked, the first spatial dim over ``model``; the
    shards tile the batch; an axis the mesh lacks cuts nothing; unequal shards raise."""
    full = torch.arange(4 * 2 * 8 * 2 * 2, dtype=torch.float32).reshape(4, 2, 8, 2, 2)
    for rank, r in enumerate(mesh_reports):
        d, m = rank // 2, rank % 2
        assert torch.equal(r["shard_data"], full[2 * d:2 * d + 2]) and r["shard_data"].is_contiguous()
        assert torch.equal(r["shard_both"], full[2 * d:2 * d + 2, :, 4 * m:4 * m + 4]) and r["shard_both"].is_contiguous()
        assert tuple(r["shard_no_axis"]) == (4, 2, 8, 2, 2)


def _ring_of_three_worker(rank, world, init_method):
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = make_mesh({"model": 3})
    mine = torch.full((5,), float(rank))
    return ring_exchange(mine, mesh, "model", True)[0].item(), ring_exchange(mine, mesh, "model", False)[0].item()


def test_ring_of_three():
    """Where previous and next differ: rank r gets r - 1 going forward and r + 1 going backward, cyclically."""
    assert run_processes(_ring_of_three_worker, 3, timeout=120) == [(2.0, 1.0), (0.0, 2.0), (1.0, 0.0)]


def test_run_processes_leaves_no_process():
    """When the call returns, the workers are gone and so is the resource tracker that Python started beside them:
    a program that ends right after it leaves nothing running."""
    before = child_processes()
    assert run_processes(_ring_of_three_worker, 3, timeout=120)[0] == (2.0, 1.0)
    assert {pid: cmd for pid, cmd in child_processes().items() if pid not in before} == {}


def test_run_processes_forks_from_the_fork_server():
    """``start_method="forkserver"``: the same results, the workers forked from a server that preloaded torch; once
    the server and its resource tracker are stopped, nothing started here is left."""
    import multiprocessing
    from multiprocessing import forkserver, resource_tracker

    before = child_processes()
    multiprocessing.set_forkserver_preload(["torch"])
    try:
        assert run_processes(_ring_of_three_worker, 3, timeout=120, start_method="forkserver") == [
            (2.0, 1.0), (0.0, 2.0), (1.0, 0.0)]
        new = {pid: cmd for pid, cmd in child_processes().items() if pid not in before}
        assert any("forkserver" in cmd for cmd in new.values())
    finally:
        forkserver._forkserver._stop()
        resource_tracker._resource_tracker._stop()
        multiprocessing.set_forkserver_preload([])
    assert {pid: cmd for pid, cmd in child_processes().items() if pid not in before} == {}


def _failing_worker(rank, world, init_method, how):
    """The second process dies or hangs; the first waits for it in a collective."""
    import time

    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    if rank == 1 and how == "dies":
        raise SystemExit(7)
    if rank == 1:
        time.sleep(600)
    dist.all_reduce(torch.zeros(1))
    return rank


@pytest.mark.parametrize("how,error,match", [("dies", RuntimeError, "exited with code"), ("hangs", TimeoutError, "within 8 s")])
def test_run_processes_stops_everything_when_a_worker_fails(how, error, match):
    """A worker that dies fails the call at once, one that hangs fails it at the time limit; no process stays."""
    import multiprocessing
    import time

    t0 = time.monotonic()
    with pytest.raises(error, match=match):
        run_processes(_failing_worker, 2, how, timeout=8 if how == "hangs" else 120)
    assert time.monotonic() - t0 < 60 and not multiprocessing.active_children()
    assert not any("resource_tracker" in cmd for cmd in child_processes().values())


def _train_worker(rank, world, init_method, batches, accum_steps):
    """``STEPS`` data-parallel steps on the whole batches; metrics, the first step's gradients, the parameters."""
    torch.set_num_threads(1)
    initialize_distributed(init_method, world, rank, backend="gloo")
    mesh = data_parallel_mesh()
    state = trainer.create_train_state(_model(), device="cpu", **OPT)
    if rank:  # the first process's parameters must reach the others
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
    step = trainer.make_train_step(state.model, accum_steps=accum_steps, mesh=mesh)
    metrics, grads = [], None
    for batch in batches:
        state, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
    logits = trainer.make_eval_step(state.model, mesh=mesh)(batches[0]["image"])
    return metrics, grads, {k: p.detach().clone() for k, p in state.model.named_parameters()}, logits


@pytest.fixture(scope="module")
def one_process_steps():
    batches = [_batch(seed=s) for s in range(STEPS)]
    state = trainer.create_train_state(_model(), device="cpu", **OPT)
    step = trainer.make_train_step(state.model)
    metrics, grads = [], None
    for batch in batches:
        state, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
    logits = trainer.make_eval_step(state.model)(batches[0]["image"])
    return batches, metrics, grads, dict(state.model.named_parameters()), logits


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_data_parallel_step_equals_the_one_process_step(one_process_steps, accum_steps):
    """Two gloo processes, each on half of a batch of 4, against one process on the whole batch, f32: loss and
    gradient norm per step to rtol 1e-6, the first step's gradients leaf for leaf to 1e-5 of each leaf's largest
    entry (measured 2.5e-6 at the stem, whose entries sum 16 K voxels per sample), the parameters after two AdamW updates to atol 5e-6 (a shard's mean is summed in another order than the
    batch's, and AdamW's normalised update lr m / (sqrt(v) + eps) passes a small gradient's rounding on at the size
    of lr = 1e-3: measured 1.1e-6 at one entry of 1024); both processes end with the same parameters bit for bit, and the eval step gathers the whole batch's
    logits.  With ``accum_steps=2`` the gradients cross once per step."""
    batches, want_metrics, want_grads, want_params, want_logits = one_process_steps
    results = run_processes(_train_worker, 2, batches, accum_steps, timeout=240)
    for metrics, grads, params, logits in results:
        np.testing.assert_allclose(metrics, want_metrics, rtol=1e-6)
        for key, want in want_grads.items():
            assert (grads[key] - want).abs().max() <= 1e-5 * want.abs().max(), key
        for key, want in want_params.items():
            np.testing.assert_allclose(params[key].numpy(), want.detach().numpy(), rtol=0, atol=5e-6, err_msg=key)
        np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), rtol=1e-5, atol=1e-5)
    for key, p in results[0][2].items():
        assert torch.equal(p, results[1][2][key]), key


def test_initialize_distributed_names_its_choice(tmp_path, capsys):
    """On the CPU the device count decides for gloo and the primary process prints it; a backend this build lacks
    raises; without a group ``make_mesh`` raises and this process is the primary one."""
    assert process_is_primary() and not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed first"):
        make_mesh({"data": 1})
    with pytest.raises(RuntimeError, match="'nccl' is not available"):
        initialize_distributed(f"file://{tmp_path}/a", 1, 0, backend="nccl")
    with pytest.raises(RuntimeError, match="'mpi4' is not available"):
        initialize_distributed(f"file://{tmp_path}/b", 1, 0, backend="mpi4")
    try:
        assert initialize_distributed(f"file://{tmp_path}/c", 1, 0) == "gloo"
        assert "backend gloo (0 CUDA device(s) for 1 process(es))" in capsys.readouterr().out
        mesh = make_mesh({"model": -1})
        assert mesh.axis_size("model") == 1 and mesh.axis_index("model") == 0
        x = torch.rand(3)
        y = ring_exchange(x, mesh, "model")
        assert torch.equal(x, y) and y.data_ptr() != x.data_ptr()  # a ring of one is a local copy
    finally:
        dist.destroy_process_group()


class _BatchStatisticsNorm(torch.nn.Module):
    """A norm over the batch and the volume (as ``BatchNorm``), for which the port has no slab path."""

    def __init__(self, channels, dtype=None, device=None):
        super().__init__()

    def forward(self, x):
        return (x - x.mean()) / (x.std() + 1e-5)


def test_train_step_refuses_spatial_axis_by_name():
    """``make_train_step(spatial_axis=)`` takes only a model with a slab path, whatever the axis's size: a module
    without ``slab_path_missing`` raises by name; a Factorizer whose block norm has no slab path (``BatchNorm``-like:
    statistics this port does not sum over slabs) is taken, its route the whole model gathered (the rule names the
    norm), and so is the flat NMF route (``use_windowed: False``, gathered), in one process (a mesh of one, no group);
    the axis needs a mesh, and one the mesh has.  (``tests/test_torch_multidevice.py``, ``tests/test_torch_slabs.py``
    and ``tests/test_torch_slab_gaps.py`` run the step on processes.)"""
    mesh = ftt.model_parallel_mesh()
    assert mesh.size == 1 and dict(mesh.shape) == {"data": 1, "model": 1} and not dist.is_initialized()
    flat = ftt.Factorizer(**CONFIG, reshape=(ftt.SWMatricize, SW), factorize_options={"use_windowed": False},
                          device="cpu")
    trainer.make_train_step(flat, mesh=mesh, spatial_axis="model")
    other_norm = ftt.Factorizer(**CONFIG, reshape=(ftt.SWMatricize, SW), norm=_BatchStatisticsNorm, device="cpu")
    assert other_norm.slab_path_missing() is None
    route = other_norm.slab_route(Cut.equal(32, 2))
    assert route.level == 0 and "_BatchStatisticsNorm (blocks.0.norm1)" in route.reason
    trainer.make_train_step(other_norm, mesh=mesh, spatial_axis="model")
    with pytest.raises(NotImplementedError, match="Linear has no slab path"):
        trainer.make_train_step(torch.nn.Linear(2, 2), mesh=mesh, spatial_axis="model")
    with pytest.raises(ValueError, match="needs a mesh"):
        trainer.make_train_step(_model(), spatial_axis="model")
    with pytest.raises(ValueError, match="not 'rows'"):
        trainer.make_train_step(_model(), mesh=mesh, spatial_axis="rows")
    trainer.make_train_step(_model(), mesh=mesh, spatial_axis="model")  # a slab path: taken
