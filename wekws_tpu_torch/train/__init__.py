"""Training: steps, executor, checkpoints, averaging, lr schedule."""

from wekws_tpu_torch.train.average import average_checkpoints
from wekws_tpu_torch.train.checkpoint import (
    link_final,
    load_checkpoint,
    load_checkpoint_info,
    load_jax_checkpoint,
    load_model_state,
    save_checkpoint,
)
from wekws_tpu_torch.train.executor import Executor
from wekws_tpu_torch.train.scheduler import ReduceLROnPlateau
from wekws_tpu_torch.train.steps import TrainState, Trainer, make_optimizer

__all__ = [
    "Executor",
    "ReduceLROnPlateau",
    "TrainState",
    "Trainer",
    "average_checkpoints",
    "link_final",
    "load_checkpoint",
    "load_checkpoint_info",
    "load_jax_checkpoint",
    "load_model_state",
    "make_optimizer",
    "save_checkpoint",
]
