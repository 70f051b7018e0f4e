"""Training criteria: max-pooling, cross-entropy and CTC."""

from wekws_tpu_torch.losses.ctc_compact import ctc_loss_compact
from wekws_tpu_torch.losses.losses import (
    acc_frame,
    criterion,
    criterion_per_utt,
    cross_entropy,
    ctc_loss,
    max_pooling_loss,
    max_pooling_per_utt,
)
from wekws_tpu_torch.losses.mask import padding_mask

__all__ = [
    "acc_frame",
    "criterion",
    "criterion_per_utt",
    "cross_entropy",
    "ctc_loss",
    "ctc_loss_compact",
    "max_pooling_loss",
    "max_pooling_per_utt",
    "padding_mask",
]
