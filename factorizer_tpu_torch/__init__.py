"""factorizer_tpu_torch: the PyTorch and CUDA (Hopper) port of factorizer_tpu.

Mirrors the JAX package's tree.  Imports torch only, never jax; the CUDA
kernels build at their first launch, not at import.  Conventional alias:
``import factorizer_tpu_torch as ftt``.
"""

from .factorization import NMF, Deconv, MatrixFactorization, RandomInit, batched_conv, sconv
from .layers import (
    MLP,
    Conv,
    ConvTranspose,
    GroupNorm,
    Identity,
    InstanceNorm,
    LayerNorm,
    Linear,
    PositionalEmbedding,
)
from .models import (
    Deconver,
    DeconverBlock,
    DeconverStage,
    DeconvMixer,
    FactMixer,
    Factorizer,
    FactorizerBlock,
    FactorizerStage,
    Stem,
    UNet,
)
from .ops import Matricize, Reshape, SWMatricize
from .ops.kernels import reference_kernels
from .train import create_train_state, dice_ce_loss, make_eval_step, make_train_step, sliding_window_inference
from .utils import load_flax_variables, resolve_device
from .zoo_scripts import (
    brats23_network,
    brats23_optimizer_settings,
    deconver_brats23_network,
    deconver_fives_network,
    ensemble_predict,
)

__version__ = "0.1.0"
