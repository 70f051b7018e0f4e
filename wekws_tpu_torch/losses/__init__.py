"""Training criteria (max-pooling and cross-entropy; CTC is not ported
yet)."""

from wekws_tpu_torch.losses.losses import (
    acc_frame,
    criterion,
    criterion_per_utt,
    cross_entropy,
    max_pooling_loss,
    max_pooling_per_utt,
)
from wekws_tpu_torch.losses.mask import padding_mask

__all__ = [
    "acc_frame",
    "criterion",
    "criterion_per_utt",
    "cross_entropy",
    "max_pooling_loss",
    "max_pooling_per_utt",
    "padding_mask",
]
