"""Training: train state and steps, the Trainer, checkpoints (scored and
full-state, and the import of the reference's torch checkpoints), the
Noise2Void step, and the entries ``python -m
exaspim_tpu_torch.train.train_bm4dnet`` (cache-only, BM4D teachers) and
``python -m exaspim_tpu_torch.train.train_n2v`` (noisy data only)."""

from exaspim_tpu_torch.train.checkpoint import (
    checkpoint_filename,
    find_best_checkpoint,
    import_torch_checkpoint,
    load_checkpoint,
    restore_pipeline,
    restore_train_state,
    save_checkpoint,
    save_train_state,
)
from exaspim_tpu_torch.train.n2v import make_blind_spots, make_n2v_train_step
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
    "import_torch_checkpoint",
    "load_checkpoint",
    "make_blind_spots",
    "make_n2v_train_step",
    "make_eval_step",
    "make_train_step",
    "restore_pipeline",
    "restore_train_state",
    "save_checkpoint",
    "save_train_state",
]
