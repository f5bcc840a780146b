"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain PyTorch version.

Importing this package builds nothing: the kernels compile at their first
launch (see :mod:`.build`).
"""

from .build import reference_kernels
from .mlp_block import prenorm_mlp, prenorm_mlp_plain
from .windowed_nmf import windowed_nmf, windowed_nmf_plain

__all__ = ["reference_kernels", "prenorm_mlp", "prenorm_mlp_plain", "windowed_nmf", "windowed_nmf_plain"]
