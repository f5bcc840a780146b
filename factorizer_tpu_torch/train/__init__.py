from .checkpoint import CheckpointManager, load_checkpoints, restore_checkpoint, save_checkpoint
from .losses import bce_with_logits, deep_supervision_loss, dice_ce_loss, dice_loss
from .loop import EnsembleEvaluator, Evaluator, SegmentationTrainer
from .metrics import MeanDice, MeanHausdorffDistance, dice_metric, hausdorff_distance_95
from .schedules import clip_by_global_norm, global_norm, make_adamw, warmup_cosine_schedule
from .sliding_window import (
    SlidingWindowInfererAdapt,
    compute_importance_map,
    sliding_window_inference,
    sliding_window_positions,
)
from .trainer import TrainState, create_train_state, make_eval_step, make_train_step

__all__ = [
    "bce_with_logits", "deep_supervision_loss", "dice_ce_loss", "dice_loss",
    "dice_metric", "MeanDice", "hausdorff_distance_95", "MeanHausdorffDistance",
    "clip_by_global_norm", "global_norm", "make_adamw", "warmup_cosine_schedule",
    "compute_importance_map", "sliding_window_inference", "sliding_window_positions", "SlidingWindowInfererAdapt",
    "TrainState", "create_train_state", "make_eval_step", "make_train_step",
    "SegmentationTrainer", "Evaluator", "EnsembleEvaluator",
    "CheckpointManager", "save_checkpoint", "restore_checkpoint", "load_checkpoints",
]
