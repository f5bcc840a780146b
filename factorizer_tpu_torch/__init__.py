"""factorizer_tpu_torch: the PyTorch and CUDA (Hopper) port of factorizer_tpu.

Mirrors the JAX package's tree.  Imports torch only, never jax; the CUDA
kernels build at their first launch, not at import.  Conventional alias:
``import factorizer_tpu_torch as ftt``.
"""

from .factorization import NMF, MatrixFactorization, RandomInit
from .layers import MLP, Conv, ConvTranspose, Identity, LayerNorm, Linear, PositionalEmbedding
from .models import FactMixer, Factorizer, FactorizerBlock, FactorizerStage, UNet
from .ops import Matricize, Reshape, SWMatricize
from .ops.kernels import reference_kernels
from .train import sliding_window_inference
from .utils import load_flax_variables
from .zoo_scripts import brats23_network, ensemble_predict

__version__ = "0.1.0"
