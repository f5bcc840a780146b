"""The multi-device layer: process mesh, exchanges, batch sharding, data parallelism and slabs.

PyTorch counterpart of ``factorizer_tpu/parallel``.  One process drives one
card (or, on the CPU and where processes share a card, one gloo rank);
``torch.distributed`` carries what the JAX package leaves to XLA's collectives.
"""

from .collectives import (
    all_gather_cat, all_reduce_sum, broadcast_from_first, cut_slab, gather_slabs, halo_exchange, ring_exchange, slab_sum,
)
from .launch import child_processes, run_processes
from .mesh import (
    Mesh, agree_backend, data_parallel_mesh, data_process_groups, initialize_distributed, local_device_count, make_mesh,
    model_parallel_mesh, process_count, process_index, process_is_primary,
)
from .sharding import data_parallel, shard_batch
from .slabs import Slabs, on_slabs, require_slab_path

__all__ = [
    "Mesh", "make_mesh", "data_parallel_mesh", "model_parallel_mesh", "data_process_groups", "initialize_distributed",
    "agree_backend", "local_device_count", "process_is_primary", "process_count", "process_index",
    "ring_exchange", "all_gather_cat", "broadcast_from_first", "halo_exchange", "all_reduce_sum", "slab_sum",
    "gather_slabs", "cut_slab", "shard_batch", "data_parallel", "Slabs", "on_slabs", "require_slab_path", "run_processes",
    "child_processes",
]
