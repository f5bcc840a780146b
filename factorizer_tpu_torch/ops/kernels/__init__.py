"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain PyTorch version.

Importing this package builds nothing: the kernels compile at their first
launch (see :mod:`.build`).
"""

from .build import reference_kernels
from .depthwise_conv import depthwise_conv, depthwise_conv_dw, depthwise_conv_dw_plain, depthwise_conv_plain
from .mlp_block import prenorm_mlp, prenorm_mlp_backward, prenorm_mlp_backward_plain, prenorm_mlp_plain
from .nmf import nmf_reconstruct, nmf_reconstruct_backward, nmf_reconstruct_backward_plain, nmf_reconstruct_plain
from .windowed_nmf import (
    windowed_nmf,
    windowed_nmf_backward,
    windowed_nmf_backward_plain,
    windowed_nmf_factors,
    windowed_nmf_factors_plain,
    windowed_nmf_plain,
    windowed_nmf_reconstruct,
    windowed_nmf_reconstruct_plain,
)
from .windowed_sharded import (
    windowed_nmf_multi_spatial,
    windowed_nmf_multi_spatial_local,
    windowed_nmf_multi_spatial_plain,
    windowed_nmf_slab_backward_pass,
    windowed_nmf_slab_factors,
    windowed_nmf_slab_reconstruct,
    windowed_nmf_slab_tail,
)

__all__ = [
    "reference_kernels",
    "depthwise_conv", "depthwise_conv_plain", "depthwise_conv_dw", "depthwise_conv_dw_plain",
    "nmf_reconstruct", "nmf_reconstruct_plain", "nmf_reconstruct_backward", "nmf_reconstruct_backward_plain",
    "prenorm_mlp", "prenorm_mlp_plain", "prenorm_mlp_backward", "prenorm_mlp_backward_plain",
    "windowed_nmf", "windowed_nmf_plain", "windowed_nmf_backward", "windowed_nmf_backward_plain",
    "windowed_nmf_factors", "windowed_nmf_factors_plain", "windowed_nmf_reconstruct", "windowed_nmf_reconstruct_plain",
    "windowed_nmf_multi_spatial", "windowed_nmf_multi_spatial_local", "windowed_nmf_multi_spatial_plain",
    "windowed_nmf_slab_factors", "windowed_nmf_slab_reconstruct", "windowed_nmf_slab_backward_pass",
    "windowed_nmf_slab_tail",
]
