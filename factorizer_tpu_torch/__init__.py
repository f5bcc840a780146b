"""factorizer_tpu_torch: the PyTorch and CUDA (Hopper) port of factorizer_tpu.

Mirrors the JAX package's tree.  Imports torch only, never jax; the CUDA
kernels build at their first launch, not at import.  The training workflow
(``data``: NIfTI IO, datasets, loader, transforms; ``train``: metrics,
checkpoints, ``SegmentationTrainer``, ``Evaluator``, ``EnsembleEvaluator``) is
exported here as the JAX package's ``train`` and ``data`` export it, and so are
the conv blocks and the baseline models (``DynUNet``, ``SegResNet``,
``SwinUNETR``, ``UNETR``), which the bundles' ``network_def`` names, and the
factorization engine as the JAX package's ``factorization``, ``layers`` and
``ops`` export it (solvers, initializers, ``SVD``, the clustering layers, the
positional embeddings, ``dot`` / ``softmax`` / ``kl_divergence``), so that a
``network_def``'s ``$ftx.<Name>`` resolves to the port's.  Conventional alias:
``import factorizer_tpu_torch as ftt``.
"""

from .factorization import (
    INIT_DISPATCH_MAP,
    NMF,
    SOLVER_DISPATCH_MAP,
    SVD,
    BCDSolver,
    Compose,
    CoordinateDescent,
    Deconv,
    EntropyKMeans,
    FastMultiplicativeUpdate,
    FuzzyCMeans,
    KMeans,
    LeastSquares,
    MatrixFactorization,
    MultiplicativeUpdate,
    NNDSVDInit,
    ProjectedGradient,
    RandomInit,
    SemiMultiplicativeUpdate,
    SVDInit,
    WeightedMultiplicativeUpdate,
    batched_conv,
    infer_rank,
    parse_init,
    parse_solver,
    randomized_svd,
    sconv,
    translate_mf_kwargs,
)
from .layers import (
    ACTIVATIONS,
    MLP,
    AxialPositionalEmbedding,
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
    PosEmbed,
    PositionalEmbedding,
    PreActivationBlock,
    RotaryPositionalEmbedding,
    SepConv,
    SinusoidalPositionalEmbedding,
    resolve_activation,
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
    Same,
    SegResBlock,
    SegResNet,
    Stem,
    SwinBlock,
    SwinUNETR,
    UNet,
    WindowAttention,
)
from .ops import Matricize, Reshape, SWMatricize, dot, kl_divergence, norm2, relative_error, softmax
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
from .utils import (
    Universaltuple,
    as_tuple,
    cumprod,
    has_args,
    is_partializable,
    load_flax_variables,
    materialize,
    partialize,
    resolve_device,
    spec_accepts,
    to_ntuple,
)
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
