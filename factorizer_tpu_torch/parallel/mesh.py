"""Process mesh with named axes over ``torch.distributed``.

PyTorch counterpart of ``factorizer_tpu/parallel/mesh.py`` (``make_mesh``,
``data_parallel_mesh``, ``model_parallel_mesh``, ``data_process_groups``,
``initialize_distributed``, ``process_is_primary``).  A JAX mesh is an array
of devices that one controller addresses; here every process is one entry of
the mesh and holds, per axis, the process group of the line through it.  Axes
used by the port:

    ``data``   the batch: data parallelism, gradients averaged over the axis
    ``model``  the first spatial axis of a volume: slabs with halo exchanges
               (``parallel.slabs``, ``ops.kernels.windowed_nmf_multi_spatial``),
               and the large weights, cut by JAX's rule

``data_parallel_mesh()`` and ``model_parallel_mesh()`` work without a process
group: one process is then a mesh of one, whose axes have size 1 and no
group, as a one-device JAX mesh.  ``model`` also carries the parameters that
JAX's ``param_sharding_rules`` cuts (``parallel.sharding.shard_parameters``).
"""

from __future__ import annotations

import math
import os
import socket
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.constants import default_pg_timeout

__all__ = ["Mesh", "make_mesh", "data_parallel_mesh", "model_parallel_mesh", "data_process_groups",
           "initialize_distributed", "agree_backend", "describe_hosts", "local_device_count", "process_is_primary",
           "process_count", "process_index"]


@dataclass(frozen=True)
class Mesh:
    """This process's place in a mesh of ``math.prod(shape.values())`` processes.

    ``shape`` maps axis name to size, in order (the last axis varies fastest
    over the ranks, as a reshape of JAX's device list does); ``coords`` is this
    process's index along each axis; ``axis_ranks[name]`` lists the global
    ranks of the line through this process along ``name``, in axis order, and
    ``groups[name]`` is that line's process group (None in a mesh of one
    process without a group, whose lines hold this process alone).
    """

    shape: Mapping[str, int]
    coords: Mapping[str, int]
    axis_ranks: Mapping[str, tuple[int, ...]]
    groups: Mapping[str, Optional[dist.ProcessGroup]]

    @property
    def size(self) -> int:
        """The number of processes in the mesh."""
        return math.prod(self.shape.values())

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    def _known(self, name: str) -> str:
        if name not in self.shape:
            raise ValueError(f"the mesh has axes {self.axis_names}, not {name!r}")
        return name

    def axis_size(self, name: str) -> int:
        return self.shape[self._known(name)]

    def axis_index(self, name: str) -> int:
        return self.coords[self._known(name)]

    def group(self, name: str) -> Optional[dist.ProcessGroup]:
        return self.groups[self._known(name)]


CPU = "cpu"  # what a process without a card publishes as its device (agree_backend)


def agree_backend(devices: Sequence[str], backend: Optional[str] = None) -> tuple[str, str]:
    """The backend that every process takes, and why, from the device each one would run on.

    ``devices`` holds, in rank order, each process's card (its UUID) or
    ``CPU``.  NCCL where every process has a card and no two share one (NCCL
    refuses two ranks on one device), else gloo.  A caller's ``backend`` is
    taken as it is, except ``"nccl"`` where a process has no card or shares
    one, which raises ``RuntimeError`` naming the processes.  A pure function
    of what all processes published, so each process reaches the same answer.
    """
    holders: dict[str, list[int]] = {}
    for rank, device in enumerate(devices):
        if device != CPU:
            holders.setdefault(device, []).append(rank)
    shared = [ranks for ranks in holders.values() if len(ranks) > 1]
    own_card = CPU not in devices and not shared
    if backend is None:
        return ("nccl" if own_card else "gloo"), f"{len(holders)} CUDA device(s) for {len(devices)} process(es)"
    if backend == "nccl" and not own_card:
        why = ([f"processes {' and '.join(map(str, ranks))} share card {devices[ranks[0]]}" for ranks in shared]
               + [f"process {r} has no card" for r, d in enumerate(devices) if d == CPU])
        raise RuntimeError(f"torch.distributed backend 'nccl' needs a card of its own for each process: {'; '.join(why)}"
                           " (take gloo, or start no more processes on a host than it has cards)")
    return backend, "the caller's choice"


def describe_hosts(hosts: Sequence[str], local_ranks: Sequence[int], local_world_sizes: Sequence[int]) -> str:
    """The hosts and their processes, from what every process published in rank order (its host, local rank and
    local world size); raises ``ValueError`` where a host's processes were told another count or other local
    ranks than the host runs, as an explicit join of several hosts without ``local_rank`` /
    ``local_world_size`` would give them."""
    by_host: dict[str, list[int]] = {}
    for rank, host in enumerate(hosts):
        by_host.setdefault(host, []).append(rank)
    for host, ranks in by_host.items():
        if (sorted(local_ranks[r] for r in ranks) != list(range(len(ranks)))
                or any(local_world_sizes[r] != len(ranks) for r in ranks)):
            raise ValueError(f"initialize_distributed: host {host} runs processes {ranks}, told local ranks "
                             f"{[local_ranks[r] for r in ranks]} of {[local_world_sizes[r] for r in ranks]}: give each "
                             "process its local_rank and local_world_size on its host")
    return f"{len(by_host)} host(s): " + ", ".join(f"{host} {len(ranks)} process(es)" for host, ranks in by_host.items())


def initialize_distributed(init_method: str = "env://", world_size: Optional[int] = None, rank: Optional[int] = None,
                           backend: Optional[str] = None, local_rank: Optional[int] = None,
                           local_world_size: Optional[int] = None) -> str:
    """Join the default process group and return the backend taken, the same on every process.

    Two forms.  Explicit: ``init_method`` is the meeting point
    (``tcp://host:port`` or ``file://path``), ``world_size`` and ``rank`` are
    given, and ``local_rank`` / ``local_world_size`` place the process on its
    host (default: one host, ``rank`` of ``world_size``; JAX's
    ``local_device_ids``).  ``"env://"``, the default: ``torchrun``'s
    environment names them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), on one node or
    several (``--nnodes``).

    With cards, a process runs on card ``local_rank`` where its host has a
    card for each of its processes, else on card 0.  The processes meet at
    the rendezvous store first and each publishes that card (its UUID, or
    ``CPU``), its host and its place there; every process then takes the
    backend :func:`agree_backend` gives for the whole table (the caller's
    ``backend`` if any) and joins through the same store.  A backend this
    build of PyTorch lacks, ``"nccl"`` on a shared card and a host whose
    processes were told another count than it runs raise, on every process
    before any collective.  The primary process prints the choice and the hosts.
    """
    if init_method == "env://":
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
        local_rank = int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
        local_world_size = (int(os.environ.get("LOCAL_WORLD_SIZE", world_size)) if local_world_size is None
                            else local_world_size)
    elif world_size is None or rank is None:
        raise ValueError(f"initialize_distributed({init_method!r}) needs world_size and rank")
    else:
        local_rank = rank if local_rank is None else local_rank
        local_world_size = world_size if local_world_size is None else local_world_size
    if not 0 <= local_rank < local_world_size <= world_size:
        raise ValueError(f"initialize_distributed: local rank {local_rank} of {local_world_size} in a world of {world_size}")
    available = {"nccl": dist.is_nccl_available, "gloo": dist.is_gloo_available}
    if backend is not None and (backend not in available or not available[backend]()):
        raise RuntimeError(f"torch.distributed backend {backend!r} is not available in this build of PyTorch")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    card = (local_rank if cards >= local_world_size else 0) if cards else None
    device = CPU if card is None else str(torch.cuda.get_device_properties(card).uuid)
    host = socket.gethostname() + (f"/node {os.environ['GROUP_RANK']}" if "GROUP_RANK" in os.environ else "")

    store, rank, world_size = next(dist.rendezvous(init_method, rank, world_size))
    store.set_timeout(default_pg_timeout)
    table = dist.PrefixStore("factorizer_tpu_torch/processes", store)
    table.set(str(rank), "\t".join((device, host, str(local_rank), str(local_world_size))))
    rows = [table.get(str(r)).decode().split("\t") for r in range(world_size)]
    # Every process has read the table before any goes on: a process that raises below may take the store with it.
    table.set(f"read/{rank}", "")
    table.wait([f"read/{r}" for r in range(world_size)])
    hosts = describe_hosts([row[1] for row in rows], [int(row[2]) for row in rows], [int(row[3]) for row in rows])
    backend, reason = agree_backend([row[0] for row in rows], backend)
    if card is not None:
        torch.cuda.set_device(card)
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg", store), world_size=world_size, rank=rank)
    if rank == 0:
        print(f"[distributed] backend {backend} ({reason}), world size {world_size}, {hosts}", flush=True)
    return backend


def local_device_count() -> int:
    """The processes on this host, each one device (JAX's ``jax.local_device_count()``): ``LOCAL_WORLD_SIZE`` (as
    ``torchrun`` and ``run_processes`` set it), else the world size, else 1."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return process_count()


def process_count() -> int:
    """The processes of the default group, 1 without one (JAX's ``jax.process_count()``)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank, 0 without a group (JAX's ``jax.process_index()``)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_is_primary() -> bool:
    """True on the process that should log and checkpoint: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(axes: Mapping[str, int]) -> Mesh:
    """A mesh with named axes over all processes of the default group.

    ``axes`` maps axis name to size, in order; one size may be -1 and absorbs
    the remaining processes.  Collective: every process calls it with the same
    ``axes``, since each axis's groups are created by all of them together.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed: call initialize_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    names, sizes = list(axes), [int(s) for s in axes.values()]
    if sizes.count(-1) > 1 or any(s < 1 and s != -1 for s in sizes):
        raise ValueError(f"axis sizes must be positive, with at most one -1: {dict(axes)}")
    if -1 in sizes:
        sizes[sizes.index(-1)] = world // math.prod(s for s in sizes if s != -1)
    if math.prod(sizes) != world:
        raise ValueError(f"a mesh {dict(zip(names, sizes))} needs {math.prod(sizes)} processes, the group has {world}")
    grid = torch.arange(world).reshape(sizes)
    mine = [int(v) for v in (grid == rank).nonzero()[0]]
    axis_ranks, groups = {}, {}
    for k, name in enumerate(names):
        # Every line along axis k, in a fixed order: new_group is collective over the whole default group.
        for line in grid.movedim(k, -1).reshape(-1, sizes[k]).tolist():
            group = dist.new_group(line)
            if rank in line:
                axis_ranks[name], groups[name] = tuple(line), group
    return Mesh(dict(zip(names, sizes)), dict(zip(names, mine)), axis_ranks, groups)


def _mesh_of_one(axes: Mapping[str, int]) -> Mesh:
    """The mesh of a process without a group: every axis of size 1, lines of this process alone."""
    return Mesh(dict.fromkeys(axes, 1), dict.fromkeys(axes, 0), dict.fromkeys(axes, (0,)), dict.fromkeys(axes))


def data_parallel_mesh(n: Optional[int] = None) -> Mesh:
    """A one-axis ``data`` mesh over ``n`` processes (default: all of them); a mesh of one without a group."""
    if not dist.is_initialized() and n in (None, 1):
        return _mesh_of_one({"data": 1})
    return make_mesh({"data": -1 if n is None else n})


def model_parallel_mesh(data: int = -1, model: Optional[int] = None, model_across_processes: bool = True) -> Mesh:
    """A ``{data, model}`` mesh over the processes (JAX ``model_parallel_mesh``).

    ``model`` defaults to the process count when there is more than one
    process, else 1: a process is one device here, so JAX's model axis of 2 on
    one multi-chip host does not arise.  ``data = -1`` takes the rest.  With
    ``model_across_processes`` (the default) every ``model`` line spans
    processes, each of which holds one device, so the only layout with more
    than one process is ``{data 1, model n}``, as JAX's rule gives it
    (``model`` a multiple of the process count, ``data`` at most the devices
    of a process); without it ``data`` varies slowest over the ranks, as
    JAX's ``[process, local device]`` grid reshaped.  Without a group: a mesh
    of one.
    """
    n_proc = process_count()
    model = (n_proc if n_proc > 1 else 1) if model is None else int(model)
    data = n_proc // model if data == -1 else int(data)
    if data * model != n_proc:
        raise ValueError(f"a {data} x {model} mesh over {n_proc} process(es)")
    if model_across_processes and n_proc > 1 and (model % n_proc or data > 1):
        raise ValueError(f"model_across_processes: the model axis ({model}) must span all {n_proc} processes, "
                         "each one device")
    if not dist.is_initialized():
        return _mesh_of_one({"data": 1, "model": 1})
    return make_mesh({"data": data, "model": model})


def data_process_groups(mesh: Mesh, data_axis: str = "data") -> tuple[int, int]:
    """How this process shards the datalist under ``mesh``: ``(num_groups, group_index)`` (JAX ``data_process_groups``).

    Processes on one line of the other axes share their ``data`` index, form
    one loader group and load the same rows; groups with different ``data``
    indices load disjoint partitions.  A process is one device, so the
    groups are the ``data`` indices: pure data parallelism gives
    ``(process_count, process_index)``, a ``model`` axis spanning the
    processes ``(1, 0)``.
    """
    if data_axis not in mesh.shape:
        return 1, 0
    return mesh.axis_size(data_axis), mesh.axis_index(data_axis)
