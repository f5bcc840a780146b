"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain PyTorch version.

Importing this package builds nothing: the kernels compile at their first
launch (see :mod:`.build`).
"""

from .build import reference_kernels
from .depthwise_conv import depthwise_conv, depthwise_conv_dw, depthwise_conv_dw_plain, depthwise_conv_plain
from .mlp_block import prenorm_mlp, prenorm_mlp_backward, prenorm_mlp_backward_plain, prenorm_mlp_plain
from .windowed_nmf import windowed_nmf, windowed_nmf_backward, windowed_nmf_backward_plain, windowed_nmf_plain

__all__ = [
    "reference_kernels",
    "depthwise_conv", "depthwise_conv_plain", "depthwise_conv_dw", "depthwise_conv_dw_plain",
    "prenorm_mlp", "prenorm_mlp_plain", "prenorm_mlp_backward", "prenorm_mlp_backward_plain",
    "windowed_nmf", "windowed_nmf_plain", "windowed_nmf_backward", "windowed_nmf_backward_plain",
]
