"""Start the processes of a mesh on this host and collect what they return.

PyTorch drives one device per process, where one JAX controller addresses
all devices of a host; this is the port's ``torchrun`` for a test, a smoke
run or a single-host job, and it can cut the processes into simulated hosts
as ``torchrun --nnodes`` agents on one machine would start them.  The
processes are spawned (a fresh interpreter
each, which imports the worker's module) or, where the caller asks, forked
from Python's fork server, which imported its preloaded modules once
(``multiprocessing.set_forkserver_preload``).  They meet through a file in a
temporary directory, and are watched: when one dies the others are stopped, since they
would wait for it in their next collective.  Python starts a helper of its own
beside spawned processes, the resource tracker, which would live as long as
the caller and a moment longer; when it was started here it is stopped here.
"""

from __future__ import annotations

import os
import tempfile
import time
from multiprocessing import resource_tracker
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_processes", "child_processes"]


def _entry(worker: Callable, rank: int, world_size: int, init_method: str, result: str, args: tuple,
           place: dict) -> None:
    os.environ.update(place)  # before the worker touches CUDA, which reads CUDA_VISIBLE_DEVICES once
    try:
        torch.save(worker(rank, world_size, init_method, *args), result)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def child_processes() -> dict[int, str]:
    """The live processes whose parent is this one, as ``{pid: command line}`` (read from ``/proc``)."""
    children = {}
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            state, ppid = (entry / "stat").read_text().rsplit(")", 1)[1].split()[:2]
            if int(ppid) == os.getpid() and state != "Z":
                children[int(entry.name)] = (entry / "cmdline").read_text().replace("\0", " ").strip()
        except OSError:  # the process ended while it was read
            continue
    return children


def _places(world_size: int, hosts: int) -> list[dict]:
    """Each process's environment as ``torchrun`` names it on ``hosts`` hosts of ``world_size // hosts`` processes,
    and, where this host has a card for each process, the cards that its simulated host sees."""
    if hosts < 1 or world_size % hosts:
        raise ValueError(f"run_processes: {world_size} processes do not make {hosts} hosts of equal size")
    local = world_size // hosts
    cards = torch.cuda.device_count() if hosts > 1 and torch.cuda.is_available() else 0
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = visible.split(",") if visible else [str(i) for i in range(cards)]
    places = []
    for rank in range(world_size):
        host = rank // local
        place = {"LOCAL_RANK": str(rank % local), "LOCAL_WORLD_SIZE": str(local), "GROUP_RANK": str(host)}
        if cards >= world_size:
            place["CUDA_VISIBLE_DEVICES"] = ",".join(ids[host * local:(host + 1) * local])
        places.append(place)
    return places


def run_processes(worker: Callable, world_size: int, *args: Any, timeout: float = 600.0,
                  start_method: str = "spawn", hosts: int = 1) -> list:
    """Run ``worker(rank, world_size, init_method, *args)`` in ``world_size`` new processes.

    ``worker`` is a module-level function (it is pickled by name) that joins
    the group itself (``initialize_distributed(init_method, world_size, rank,
    ...)``); ``init_method`` is a ``file://`` meeting point made here.  The
    processes make ``hosts`` simulated hosts of ``world_size // hosts`` each
    (``hosts`` must divide ``world_size``), in rank order: each process finds
    torchrun's ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and ``GROUP_RANK`` in its
    environment (its place to pass on as ``local_rank`` and
    ``local_world_size``) and, with several hosts on a host with a card for
    each process, sees only its host's cards (``CUDA_VISIBLE_DEVICES``).  Returns
    the workers' return values in rank order (anything ``torch.save`` takes).
    Raises ``RuntimeError`` when a process exits with an error and
    ``TimeoutError`` after ``timeout`` seconds; either way no process is left
    running.  ``start_method`` is ``"spawn"`` or ``"forkserver"``; a fork
    server, once started, lives until its caller stops or exits.
    """
    places = _places(world_size, hosts)
    ctx = mp.get_context(start_method)
    # The tracker of a caller that had one may hold its semaphores and shared memory, and stays.
    tracker = resource_tracker._resource_tracker
    tracker_is_ours = getattr(tracker, "_pid", None) is None
    with tempfile.TemporaryDirectory(prefix="ftt_processes_") as tmp:
        init_method = f"file://{tmp}/rendezvous"
        results = [str(Path(tmp) / f"result_{rank}.pt") for rank in range(world_size)]
        procs = [ctx.Process(target=_entry, args=(worker, rank, world_size, init_method, results[rank], args,
                                                  places[rank]))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"a worker process exited with code {failed[0]}; its traceback is on stderr")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the worker processes did not finish within {timeout:.0f} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            if tracker_is_ours:
                tracker._stop()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"worker processes exited with codes {codes}; their tracebacks are on stderr")
        return [torch.load(path, weights_only=False) for path in results]
