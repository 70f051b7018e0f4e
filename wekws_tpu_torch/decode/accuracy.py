"""Utterance-level decode accuracy for CTC validation.

Port of wekws_tpu/decode/accuracy.py (the reference wekws's
``acc_utterance``): the prefix beam search decodes each utterance's
posteriors on the host, and the token accuracy is
(N - ins - sub - del) / N * 100 over the batch.
"""

from typing import Sequence

import numpy as np

from wekws_tpu_torch.decode.calculator import Calculator
from wekws_tpu_torch.decode.ctc_prefix_beam_search import (
    ctc_prefix_beam_search,
)


def acc_utterance(
    probs: np.ndarray,
    target: np.ndarray,
    logit_lengths: Sequence[int],
    target_lengths: Sequence[int],
) -> float:
    """probs: (B, T, V) softmax posteriors (numpy, host)."""
    total = {"all": 0, "ins": 0, "sub": 0, "del": 0}
    calculator = Calculator()
    for i in range(probs.shape[0]):
        hyps = ctc_prefix_beam_search(
            probs[i], int(logit_lengths[i]), None, 3, 5
        )
        lab = [str(int(x)) for x in target[i][: int(target_lengths[i])]]
        rec = [str(int(x)) for x in hyps[0][0]] if hyps else []
        result = calculator.calculate(lab, rec)
        if result["all"] != 0:
            for k in total:
                total[k] += result[k]
    if total["all"] == 0:
        return 0.0
    return (
        float(total["all"] - total["ins"] - total["sub"] - total["del"])
        * 100.0
        / total["all"]
    )
