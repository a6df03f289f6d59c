from .optimizer import (
    TrainState,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    Leaf,
    global_norm,
    leaf_path,
    make_optimizer,
    param_leaves,
)
from .schedule import constant_schedule, cosine_schedule, linear_warmup_cosine

__all__ = [
    "TrainState", "adamw_init", "adamw_update", "adafactor_init",
    "adafactor_update", "clip_by_global_norm", "global_norm",
    "Leaf", "leaf_path", "make_optimizer", "param_leaves", "constant_schedule", "cosine_schedule",
    "linear_warmup_cosine",
]
