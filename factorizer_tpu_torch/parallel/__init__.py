"""The multi-device layer: process mesh, ring exchange, batch sharding and data parallelism.

PyTorch counterpart of ``factorizer_tpu/parallel``.  One process drives one
card (or, on the CPU and where processes share a card, one gloo rank);
``torch.distributed`` carries what the JAX package leaves to XLA's collectives.
"""

from .collectives import all_gather_cat, ring_exchange
from .launch import child_processes, run_processes
from .mesh import Mesh, data_parallel_mesh, initialize_distributed, make_mesh, process_is_primary
from .sharding import data_parallel, shard_batch

__all__ = [
    "Mesh", "make_mesh", "data_parallel_mesh", "initialize_distributed", "process_is_primary",
    "ring_exchange", "all_gather_cat", "shard_batch", "data_parallel", "run_processes", "child_processes",
]
