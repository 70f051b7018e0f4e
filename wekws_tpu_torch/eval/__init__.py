"""Scoring and DET for the max-pooling wake-word path."""

from wekws_tpu_torch.eval.det import (
    compute_det,
    frr_at_fa_per_hour,
    load_label_and_score,
    write_stats_file,
)
from wekws_tpu_torch.eval.score import write_score_file

__all__ = [
    "compute_det",
    "frr_at_fa_per_hour",
    "load_label_and_score",
    "write_score_file",
    "write_stats_file",
]
