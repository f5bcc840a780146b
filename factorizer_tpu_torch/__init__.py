"""factorizer_tpu_torch: the PyTorch and CUDA (Hopper) port of factorizer_tpu.

Mirrors the JAX package's tree.  Imports torch only, never jax; the CUDA
kernels build at their first launch, not at import.  The training workflow
(``data``: NIfTI IO, datasets, loader, transforms; ``train``: metrics,
checkpoints, ``SegmentationTrainer``, ``Evaluator``, ``EnsembleEvaluator``) is
exported here as the JAX package's ``train`` and ``data`` export it, and so are
the conv blocks and the baseline models (``DynUNet``, ``SegResNet``,
``SwinUNETR``, ``UNETR``), which the bundles' ``network_def`` names.  Conventional alias:
``import factorizer_tpu_torch as ftt``.
"""

from .factorization import NMF, Deconv, MatrixFactorization, RandomInit, batched_conv, sconv
from .layers import (
    MLP,
    BasicBlock,
    Conv,
    ConvTranspose,
    Dense,
    DoubleConv,
    Dropout,
    GroupNorm,
    Identity,
    InstanceNorm,
    LayerNorm,
    Linear,
    PositionalEmbedding,
    PreActivationBlock,
    SepConv,
)
from .models import (
    UNETR,
    Deconver,
    DeconverBlock,
    DeconverStage,
    DeconvMixer,
    DynUNet,
    DynUNetBlock,
    FactMixer,
    Factorizer,
    FactorizerBlock,
    FactorizerStage,
    SegResBlock,
    SegResNet,
    Stem,
    SwinUNETR,
    UNet,
)
from .ops import Matricize, Reshape, SWMatricize
from .ops.kernels import reference_kernels
from .parallel import data_parallel, data_parallel_mesh, initialize_distributed, make_mesh, model_parallel_mesh, shard_batch
from .data import (
    CacheDataset,
    DataLoader,
    Dataset,
    NiftiImage,
    PersistentDataset,
    load_decathlon_datalist,
    load_nifti,
    partition_datalist,
    save_nifti,
    stratified_kfold,
    transforms,
)
from .train import (
    CheckpointManager,
    EnsembleEvaluator,
    Evaluator,
    MeanDice,
    MeanHausdorffDistance,
    SegmentationTrainer,
    SlidingWindowInfererAdapt,
    TrainState,
    bce_with_logits,
    compute_importance_map,
    create_train_state,
    deep_supervision_loss,
    dice_ce_loss,
    dice_loss,
    dice_metric,
    hausdorff_distance_95,
    load_checkpoints,
    make_adamw,
    make_eval_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    sliding_window_inference,
    sliding_window_positions,
    warmup_cosine_schedule,
)
from .utils import load_flax_variables, materialize, resolve_device
from .zoo_scripts import (
    brats23_network,
    brats23_optimizer_settings,
    brats23_transforms,
    deconver_brats23_network,
    deconver_fives_network,
    deconver_isles22_network,
    ensemble_predict,
    factorizer_isles22_network,
)

__version__ = "0.1.0"
