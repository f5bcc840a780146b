from .losses import bce_with_logits, deep_supervision_loss, dice_ce_loss, dice_loss
from .schedules import clip_by_global_norm, global_norm, make_adamw, warmup_cosine_schedule
from .sliding_window import compute_importance_map, sliding_window_inference, sliding_window_positions
from .trainer import TrainState, create_train_state, make_eval_step, make_train_step

__all__ = [
    "bce_with_logits", "deep_supervision_loss", "dice_ce_loss", "dice_loss",
    "clip_by_global_norm", "global_norm", "make_adamw", "warmup_cosine_schedule",
    "compute_importance_map", "sliding_window_inference", "sliding_window_positions",
    "TrainState", "create_train_state", "make_eval_step", "make_train_step",
]
