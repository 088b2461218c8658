"""Training: train state and steps, the Trainer, checkpoints (scored and
full-state), and the cache-only training entry
(``python -m exaspim_tpu_torch.train.train_bm4dnet``)."""

from exaspim_tpu_torch.train.checkpoint import (
    checkpoint_filename,
    find_best_checkpoint,
    load_checkpoint,
    restore_pipeline,
    restore_train_state,
    save_checkpoint,
    save_train_state,
)
from exaspim_tpu_torch.train.state import (
    TrainState,
    cosine_schedule,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from exaspim_tpu_torch.train.trainer import Trainer

__all__ = [
    "TrainState",
    "Trainer",
    "checkpoint_filename",
    "cosine_schedule",
    "create_train_state",
    "find_best_checkpoint",
    "load_checkpoint",
    "make_eval_step",
    "make_train_step",
    "restore_pipeline",
    "restore_train_state",
    "save_checkpoint",
    "save_train_state",
]
