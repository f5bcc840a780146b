"""Multi-host runs of the port on the CPU: several hosts simulated on this one, as ``torchrun --nnodes`` agents start them.

* the backend rule (``parallel.mesh.agree_backend``) as a pure function of the devices that the processes publish,
  and the hosts' table (``describe_hosts``);
* ``run_processes(worker, 4, hosts=2)``: each process's rank, local rank, host and ``local_device_count()``, and the
  meshes and loader groups of ``data_parallel_mesh()`` / ``model_parallel_mesh()`` held against the JAX package's own
  functions fed the same process table (stand-in devices, one a process);
* the bundles' two multi-device programs (``train.yaml`` + ``train_multidevice.yaml`` / ``train_tp.yaml``) under two
  ``torch.distributed.run --nnodes 2 --nproc_per_node 2`` agents, then resumed on every process, against the same
  program's single-node run of 4 processes;
* two hosts that see different checkpoint directories: the resume refused by name on every process.

The workers are module-level functions run by ``parallel.run_processes``; this module imports jax only inside the
test that needs it.
"""

import ast
import contextlib
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch.config import run as bundle_run
from factorizer_tpu_torch.parallel import (
    agree_backend, child_processes, data_parallel_mesh, data_process_groups, initialize_distributed, local_device_count,
    model_parallel_mesh, run_processes,
)
from factorizer_tpu_torch.parallel.mesh import CPU, describe_hosts
from factorizer_tpu_torch.train import loop as port_loop
from torch_bundle_cases import ON_CPU, REPO, TINY_FACTORIZER, ZOO
from torch_workflow_cases import write_cases

torch.set_num_threads(1)

WORLD, HOSTS = 4, 2


def _join_as_placed(rank: int, world: int, init_method: str) -> str:
    """Join with the place on its simulated host that ``run_processes`` gave this process."""
    torch.set_num_threads(1)
    return initialize_distributed(init_method, world, rank, local_rank=int(os.environ["LOCAL_RANK"]),
                                  local_world_size=int(os.environ["LOCAL_WORLD_SIZE"]))


# -- the backend rule


@pytest.mark.parametrize("devices, asked, backend, reason", [
    ([CPU] * 4, None, "gloo", "0 CUDA device(s) for 4 process(es)"),
    (["GPU-a", "GPU-b", "GPU-c", "GPU-d"], None, "nccl", "4 CUDA device(s) for 4 process(es)"),
    (["GPU-a", "GPU-a"], None, "gloo", "1 CUDA device(s) for 2 process(es)"),  # two node agents on a one-card machine
    (["GPU-a", "GPU-b", "GPU-c", "GPU-c"], None, "gloo", "3 CUDA device(s) for 4 process(es)"),  # one host shares
    (["GPU-a", CPU], None, "gloo", "1 CUDA device(s) for 2 process(es)"),
    (["GPU-a", "GPU-a"], "gloo", "gloo", "the caller's choice"),
    (["GPU-a", "GPU-b"], "gloo", "gloo", "the caller's choice"),
])
def test_agree_backend(devices, asked, backend, reason):
    """NCCL only where every process has a card and no two share one; else gloo, whatever a host alone would
    choose; a caller's backend as it is."""
    assert agree_backend(devices, asked) == (backend, reason)


@pytest.mark.parametrize("devices, match", [
    (["GPU-a", "GPU-b", "GPU-a", "GPU-b"], "processes 0 and 2 share card GPU-a; processes 1 and 3 share card GPU-b"),
    ([CPU, CPU], "process 0 has no card; process 1 has no card"),
    (["GPU-a", CPU], "process 1 has no card"),
])
def test_agree_backend_refuses_nccl_without_a_card_each(devices, match):
    """A caller's ``nccl`` where processes share a card or have none raises, naming them."""
    with pytest.raises(RuntimeError, match=re.escape(match)):
        agree_backend(devices, "nccl")


def test_describe_hosts():
    """The hosts and their processes; a host whose processes were told another count or other local ranks (an
    explicit join of two hosts without ``local_rank`` / ``local_world_size``) raises."""
    assert describe_hosts(["a", "a", "b", "b"], [0, 1, 0, 1], [2, 2, 2, 2]) == "2 host(s): a 2 process(es), b 2 process(es)"
    assert describe_hosts(["a"], [0], [1]) == "1 host(s): a 1 process(es)"
    with pytest.raises(ValueError, match=r"host a runs processes \[0, 1\], told local ranks \[0, 1\] of \[4, 4\]"):
        describe_hosts(["a", "a", "b", "b"], [0, 1, 2, 3], [4, 4, 4, 4])
    with pytest.raises(ValueError, match="host b runs processes"):
        describe_hosts(["a", "b", "b"], [0, 0, 0], [1, 2, 2])


def test_run_processes_refuses_hosts_that_do_not_divide():
    with pytest.raises(ValueError, match="3 processes do not make 2 hosts"):
        run_processes(_place_worker, 3, hosts=2)
    assert local_device_count() == int(os.environ.get("LOCAL_WORLD_SIZE", 1))  # no group: this process alone


# -- 4 processes on 2 simulated hosts: places and meshes

MESHES = {
    "data_parallel_mesh()": dict(fn="data_parallel_mesh", kwargs={}),
    "model_parallel_mesh()": dict(fn="model_parallel_mesh", kwargs={}),
    "model_parallel_mesh(data=2, model=2, model_across_processes=False)":
        dict(fn="model_parallel_mesh", kwargs=dict(data=2, model=2, model_across_processes=False)),
}


def _place_worker(rank: int, world: int, init_method: str) -> dict:
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        backend = _join_as_placed(rank, world, init_method)
    report = {"env": {k: os.environ[k] for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK")},
              "backend": backend, "rank": torch.distributed.get_rank(), "local_device_count": local_device_count(),
              "printed": printed.getvalue(), "meshes": {}}
    factories = {"data_parallel_mesh": data_parallel_mesh, "model_parallel_mesh": model_parallel_mesh}
    for name, spec in MESHES.items():
        mesh = factories[spec["fn"]](**spec["kwargs"])
        report["meshes"][name] = (dict(mesh.shape), dict(mesh.coords), data_process_groups(mesh))
    return report


@pytest.fixture(scope="module")
def placed():
    return run_processes(_place_worker, WORLD, hosts=HOSTS, timeout=240)


def test_processes_on_two_hosts(placed):
    """Rank r runs on host r // 2 as its local rank r % 2 of 2, sees 2 local devices (JAX's
    ``local_device_count()``), and all four take gloo; the primary names both hosts and their processes."""
    for rank, r in enumerate(placed):
        assert r["rank"] == rank and r["backend"] == "gloo"
        assert r["env"] == {"LOCAL_RANK": str(rank % 2), "LOCAL_WORLD_SIZE": "2", "GROUP_RANK": str(rank // 2)}
        assert r["local_device_count"] == 2
    line = placed[0]["printed"]
    host = socket.gethostname()
    assert (f"backend gloo (0 CUDA device(s) for 4 process(es)), world size 4, 2 host(s): {host}/node 0 2 "
            f"process(es), {host}/node 1 2 process(es)") in line
    assert not any(r["printed"] for r in placed[1:])


class _StandIn:
    """A JAX device as the mesh functions read it: an id and its process."""

    def __init__(self, id: int, process_index: int):
        self.id, self.process_index = id, process_index

    def __repr__(self) -> str:
        return f"_StandIn({self.id})"


@pytest.mark.parametrize("name", list(MESHES))
def test_meshes_match_jax_on_the_same_process_table(placed, monkeypatch, name):
    """The port's mesh shape, each process's coordinates and loader groups (``data_process_groups``) equal what the
    JAX package's ``make_mesh`` / ``model_parallel_mesh`` and ``data_process_groups`` give for 4 processes of one
    device each (the port's process is JAX's process with its one card)."""
    import jax

    from factorizer_tpu.parallel import mesh as jax_mesh

    devices = [_StandIn(r, r) for r in range(WORLD)]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)
    monkeypatch.setattr(jax, "process_count", lambda *a, **k: WORLD)
    spec = MESHES[name]
    mesh = getattr(jax_mesh, spec["fn"])(**spec["kwargs"])
    grid = np.vectorize(lambda d: d.id, otypes=[int])(mesh.devices)
    for rank, r in enumerate(placed):
        shape, coords, groups = r["meshes"][name]
        monkeypatch.setattr(jax, "process_index", lambda *a, _r=rank, **k: _r)
        assert shape == dict(zip(mesh.axis_names, grid.shape)), (name, rank)
        assert coords == dict(zip(mesh.axis_names, map(int, np.argwhere(grid == rank)[0]))), (name, rank)
        assert groups == jax_mesh.data_process_groups(mesh), (name, rank)


# -- the bundle programs under two torchrun agents

OVERLAYS = {"multidevice": "train_multidevice.yaml", "tp": "train_tp.yaml"}
# Each process prints its epochs and their losses after `run` (the epochs of this leg: a resumed leg starts later).
REPORT = "$print('[report] %d %s' % (jax.process_index(), [(h['epoch'], h['loss']) for h in @trainer.history]), flush=True)"


def _overrides(root: Path, datalist: Path, program: str, leg: int) -> dict:
    return {**TINY_FACTORIZER, **ON_CPU, "data_dir": str(root / "data"), "datalist_path": str(datalist),
            "num_workers": 0, "max_epochs": leg, "val_interval": 0, "output_dir": str(root / program),
            "trainer#log_dir": None}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _agents(root: Path, datalist: Path, leg: int) -> dict:
    """Both programs' leg ``leg`` (``max_epochs: leg``) at the same time, each as two node agents of 2 processes;
    returns, by program, what each agent printed."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    started = {}
    for program, overlay in OVERLAYS.items():
        configs = ZOO / "factorizer_brats23" / "configs"
        args = [f"{k}={json.dumps(v)}" for k, v in _overrides(root, datalist, program, leg).items()]
        port = _free_port()
        started[program] = [subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(HOSTS), "--node_rank", str(node),
             "--nproc_per_node", str(WORLD // HOSTS), "--master_addr", "127.0.0.1", "--master_port", str(port),
             "-m", "factorizer_tpu_torch.bundle", "run", "--config_file", str(configs / "train.yaml"),
             "--config_file", str(configs / overlay), "--run_id", "run", "--run_id", "report", "--report", REPORT,
             *args], env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for node in range(HOSTS)]
    printed = {}
    try:
        for program, agents in started.items():
            outs = [agent.communicate(timeout=300) for agent in agents]
            for agent, (out, err) in zip(agents, outs):
                assert agent.returncode == 0, f"{program} leg {leg}: exit {agent.returncode}\n{out[-3000:]}\n{err[-4000:]}"
            printed[program] = [out for out, _ in outs]
    finally:
        for agents in started.values():
            for agent in agents:
                if agent.poll() is None:
                    agent.kill()
                    agent.communicate()
    return printed


def _reports(printed: list) -> dict:
    """Each process's ``[(epoch, loss)]`` from what the agents printed, by rank (two processes' lines may share a line
    of the agent's output: each print is one write, its newline another)."""
    return {int(rank): ast.literal_eval(values)
            for out in printed for rank, values in re.findall(r"\[report\] (\d+) (\[[^\]]*\])", out)}


def _single_node_worker(rank: int, world: int, init_method: str, root: str, datalist: str) -> dict:
    """The same programs, both legs each, on 4 processes of one host (``run_processes`` without hosts)."""
    initialize_distributed(init_method, world, rank)
    torch.set_num_threads(1)
    configs = ZOO / "factorizer_brats23" / "configs"
    out = {}
    for program, overlay in OVERLAYS.items():
        for leg in (1, 2):
            overrides = _overrides(Path(root), Path(datalist), program, leg)
            parser = bundle_run([str(configs / "train.yaml"), str(configs / overlay)], run_id="run", **overrides)
            out[(program, leg)] = [(h["epoch"], h["loss"]) for h in parser["trainer"].history]
    return out


@pytest.fixture(scope="module")
def two_nodes(tmp_path_factory):
    """10 cases (fold 0: 2 for validation, 8 for training): both programs as two node agents, a leg of 1 epoch, then
    a leg of 2 that resumes; then the single-node run of the same legs in other directories."""
    root = tmp_path_factory.mktemp("two_nodes")
    datalist = write_cases(root, 10, ftt.save_nifti, seed=3, folds=5)
    legs = {leg: _agents(root, datalist, leg) for leg in (1, 2)}
    saved = {program: sorted(p.name for p in (root / program / "ckpt").iterdir()) for program in OVERLAYS}
    single = root / "single"
    single.mkdir()
    (single / "data").symlink_to(root / "data")
    reference = run_processes(_single_node_worker, WORLD, str(single), str(datalist), timeout=300)
    return legs, saved, reference


@pytest.mark.parametrize("program", list(OVERLAYS))
def test_program_on_two_nodes(two_nodes, program):
    """``train.yaml`` + the overlay under two ``--nnodes 2`` agents of 2 processes each: exit 0; the primary's
    ``[distributed]`` line names gloo and the 2 hosts; every process reports the same epoch losses, equal to the same
    program's single-node run of 4 processes (the same ranks and partitions; rtol 1e-6 in f32, bit for bit
    expected); the resumed leg starts at epoch 1 on every process; the primary alone wrote the one kept
    checkpoint, step_2.pt."""
    legs, saved, reference = two_nodes
    for leg in (1, 2):
        printed = legs[leg][program]
        assert re.search(r"\[distributed\] backend gloo \(0 CUDA device\(s\) for 4 process\(es\)\), world size 4, "
                         r"2 host\(s\): \S+/node 0 2 process\(es\), \S+/node 1 2 process\(es\)", printed[0]), printed[0]
        reports = _reports(printed)
        assert sorted(reports) == list(range(WORLD)), reports
        assert [epoch for epoch, _ in reports[0]] == list(range(leg - 1, leg))
        want = reference[0][(program, leg)]
        for rank in range(WORLD):
            assert reports[rank] == reports[0], (program, leg, reports)
            assert reference[rank][(program, leg)] == want
            np.testing.assert_allclose([loss for _, loss in reports[rank]], [loss for _, loss in want], rtol=1e-6)
            assert np.isfinite([loss for _, loss in want]).all()
    assert saved[program] == ["step_2.pt"]


# -- hosts that see different checkpoint directories


def _resume_worker(rank: int, world: int, init_method: str, root: str) -> dict:
    """Each host's trainer over its own directory (host 0's holds step 4, host 1's none or step 2): the resume
    raises on every process; returns the messages."""
    _join_as_placed(rank, world, init_method)
    host = int(os.environ["GROUP_RANK"])
    errors = {}
    for case in ("missing", "older"):
        ckpt = Path(root) / ("newer" if host == 0 else case)
        try:
            _trainer(str(ckpt), max_epochs=3).initialize()
        except RuntimeError as exc:
            errors[case] = str(exc)
    return errors


def _trainer(ckpt_dir: str, max_epochs: int) -> port_loop.SegmentationTrainer:
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    batch = {"image": rng.standard_normal((1, 4, 8, 8, 8)).astype(np.float32),
             "label": (rng.random((1, 3, 8, 8, 8)) > 0.5).astype(np.uint8)}
    mesh = data_parallel_mesh() if torch.distributed.is_initialized() else None
    return port_loop.SegmentationTrainer(torch.nn.Conv3d(4, 3, 1), [batch, batch], None, max_epochs=max_epochs,
                                         warmup_epochs=0, roi_size=(8, 8, 8), ckpt_dir=ckpt_dir, mesh=mesh, device="cpu")


def test_hosts_that_see_different_checkpoints_refuse_the_resume(tmp_path):
    """Two simulated hosts of one process, host 0's directory at step 4 and host 1's missing, then at step 2: every
    process raises the resume error, which names the directory and the steps, within the time limit, and no process
    is left behind."""
    _trainer(str(tmp_path / "newer"), max_epochs=1).run()
    shutil.copytree(tmp_path / "newer", tmp_path / "older")
    _trainer(str(tmp_path / "newer"), max_epochs=2).run()
    errors = run_processes(_resume_worker, 2, str(tmp_path), hosts=2, timeout=120)
    for rank, got in enumerate(errors):
        for case, steps in (("missing", "[4, 0]"), ("older", "[4, 2]")):
            assert "the processes would resume from different steps of the checkpoint directory" in got[case]
            assert f"by rank {steps}: every host must see that directory" in got[case], (rank, got)
            assert repr(str(tmp_path / ("newer" if rank == 0 else case))) in got[case]
    assert not child_processes()
