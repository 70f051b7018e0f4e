"""Posterior-trajectory scoring (max-pooling wake-word path).

Numpy copy of wekws_tpu/eval/score.py.  Writes the reference wekws
score-file format (wekws/bin/score.py): one line per
(utterance, keyword): ``key keyword p(t0) p(t1) ...``, posteriors over
valid frames only.
"""

from typing import Callable, Dict, Iterable, Sequence

import numpy as np


def write_score_file(
    forward_fn: Callable[[Dict], tuple],
    dataset: Iterable[Dict],
    keyword_names: Sequence[str],
    score_file: str,
) -> int:
    """Args:
        forward_fn: batch dict -> (posteriors (B, T, K), lengths (B,))
            as numpy arrays (padded rows may be present; rows beyond
            ``len(batch['keys'])`` are ignored).
        keyword_names: index -> display token for the score file.
    Returns number of utterances scored."""
    n = 0
    with open(score_file, "w", encoding="utf8") as fout:
        for batch in dataset:
            logits, lengths = forward_fn(batch)
            logits = np.asarray(logits)
            lengths = np.asarray(lengths)
            valid = np.asarray(
                batch.get("valid", np.ones(len(batch["keys"])))
            )
            for i, key in enumerate(batch["keys"]):
                if i < len(valid) and valid[i] == 0:
                    continue  # bucketed fill row — holds no utterance
                t = int(lengths[i])
                for k, name in enumerate(keyword_names):
                    frames = " ".join(
                        f"{x:.6f}" for x in logits[i, :t, k].tolist()
                    )
                    fout.write(f"{key} {name} {frames}\n")
                n += 1
    return n
