"""Scoring and DET (the max-pooling wake-word path and the CTC path)
and utterance accuracy (the speech-commands path)."""

from wekws_tpu_torch.eval.accuracy import accuracy_over_dataset
from wekws_tpu_torch.eval.det import (
    compute_det,
    frr_at_fa_per_hour,
    load_label_and_score,
    write_stats_file,
)
from wekws_tpu_torch.eval.det_ctc import (
    compute_det_ctc,
    load_label_and_score_ctc,
    space_mixed_label,
)
from wekws_tpu_torch.eval.score import write_score_file
from wekws_tpu_torch.eval.score_ctc import (
    build_keywords_token,
    compare_ctc_score_files,
    detect_keyword,
    read_ctc_score_file,
    write_ctc_score_file,
)

__all__ = [
    "accuracy_over_dataset",
    "build_keywords_token",
    "compare_ctc_score_files",
    "compute_det",
    "compute_det_ctc",
    "detect_keyword",
    "frr_at_fa_per_hour",
    "load_label_and_score",
    "load_label_and_score_ctc",
    "read_ctc_score_file",
    "space_mixed_label",
    "write_ctc_score_file",
    "write_score_file",
    "write_stats_file",
]
