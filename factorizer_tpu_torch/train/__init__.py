from .sliding_window import compute_importance_map, sliding_window_inference, sliding_window_positions

__all__ = ["compute_importance_map", "sliding_window_inference", "sliding_window_positions"]
