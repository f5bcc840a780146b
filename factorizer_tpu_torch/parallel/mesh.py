"""Process mesh with named axes over ``torch.distributed``.

PyTorch counterpart of ``factorizer_tpu/parallel/mesh.py`` (``make_mesh``,
``data_parallel_mesh``, ``initialize_distributed``, ``process_is_primary``).
A JAX mesh is an array of devices that one controller addresses; here every
process is one entry of the mesh and holds, per axis, the process group of
the line through it.  Axes used by the port:

    ``data``   the batch: data parallelism, gradients averaged over the axis
    ``model``  the first spatial axis of a volume: slabs with a halo exchange
               (``ops.kernels.windowed_nmf_multi_spatial``)

Not ported: ``model_parallel_mesh`` and ``data_process_groups``, which lay a
mesh over several hosts' devices; ``param_sharding_rules`` is GSPMD's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "data_parallel_mesh", "initialize_distributed", "process_is_primary"]


@dataclass(frozen=True)
class Mesh:
    """This process's place in a mesh of ``math.prod(shape.values())`` processes.

    ``shape`` maps axis name to size, in order (the last axis varies fastest
    over the ranks, as a reshape of JAX's device list does); ``coords`` is this
    process's index along each axis; ``axis_ranks[name]`` lists the global
    ranks of the line through this process along ``name``, in axis order, and
    ``groups[name]`` is that line's process group.
    """

    shape: Mapping[str, int]
    coords: Mapping[str, int]
    axis_ranks: Mapping[str, tuple[int, ...]]
    groups: Mapping[str, dist.ProcessGroup]

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

    def group(self, name: str) -> dist.ProcessGroup:
        return self.groups[self._known(name)]


def initialize_distributed(init_method: str, world_size: int, rank: int, backend: Optional[str] = None) -> str:
    """Join the default process group and return the backend taken.

    ``init_method`` is the meeting point (``tcp://host:port`` or
    ``file://path``); nothing is read from the environment.  The backend is
    the caller's, else the device count decides: ``nccl`` when this host has a
    card for each of the ``world_size`` processes (process ``rank`` then takes
    card ``rank``), ``gloo`` on the CPU and where processes have to share a
    card (NCCL refuses two ranks on one device).  A backend this build of
    PyTorch lacks raises.  The primary process prints the choice.
    """
    if backend is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        backend = "nccl" if cards >= world_size else "gloo"
        reason = f"{cards} CUDA device(s) for {world_size} process(es)"
    else:
        reason = "the caller's choice"
    available = {"nccl": dist.is_nccl_available, "gloo": dist.is_gloo_available}
    if backend not in available or not available[backend]():
        raise RuntimeError(f"torch.distributed backend {backend!r} is not available in this build of PyTorch")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    if rank == 0:
        print(f"[distributed] backend {backend} ({reason}), world size {world_size}", flush=True)
    return backend


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


def data_parallel_mesh(n: Optional[int] = None) -> Mesh:
    """A one-axis ``data`` mesh over ``n`` processes (default: all of them)."""
    return make_mesh({"data": -1 if n is None else n})
