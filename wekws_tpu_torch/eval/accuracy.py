"""Utterance classification accuracy (the speech-commands path).

Port of wekws_tpu/eval/accuracy.py: the counting loop behind
``bin/compute_accuracy.py``, with the bucketed batches' fill-row guard
(a row with ``valid == 0`` holds no utterance and counts toward neither
the total nor the correct).
"""

from typing import Callable, Dict, Iterable, Tuple

import numpy as np


def accuracy_over_dataset(
    forward_fn: Callable[[Dict], tuple], dataset: Iterable[Dict]
) -> Tuple[int, int]:
    """-> (correct, total) over valid utterances only.  ``forward_fn``
    maps a batch to (logits (B, K), anything)."""
    correct, total = 0, 0
    for batch in dataset:
        logits, _ = forward_fn(batch)
        pred = np.argmax(np.asarray(logits), axis=-1)
        valid = np.asarray(
            batch.get("valid", np.ones(len(batch["keys"])))
        ).astype(bool)
        hits = (pred == np.asarray(batch["target"])) & valid
        correct += int(hits.sum())
        total += int(valid.sum())
    return correct, total
