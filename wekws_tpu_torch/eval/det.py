"""DET computation for the max-pooling wake-word path.

Numpy copy of wekws_tpu/eval/det.py, with the semantics of the
reference wekws bin/compute_det.py:
* keyword vs filler tables from data.list txt labels (upper-cased
  match) + accumulated filler audio hours;
* threshold sweep: FRR = fraction of keyword utterances whose max
  frame score < threshold; FA/h = count of triggered frames in filler
  utterances with a ``window_shift``-frame refractory skip, divided by
  filler hours.

``import_pyplot`` is the one place the port imports matplotlib (the
DET plots of ``bin/plot_det_curve.py`` and ``eval/det_ctc.py``).
"""

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np


def load_label_and_score(
    keyword: str, label_file: str, score_file: str
) -> Tuple[Dict[str, List[float]], Dict[str, List[float]], float]:
    score_table: Dict[str, List[float]] = {}
    with open(score_file, "r", encoding="utf8") as fin:
        for line in fin:
            arr = line.strip().split()
            if len(arr) < 2:
                continue
            key, current_keyword = arr[0], arr[1]
            if current_keyword == keyword and key not in score_table:
                score_table[key] = list(map(float, arr[2:]))
    keyword_table: Dict[str, List[float]] = {}
    filler_table: Dict[str, List[float]] = {}
    filler_duration = 0.0
    with open(label_file, "r", encoding="utf8") as fin:
        for line in fin:
            obj = json.loads(line.strip())
            key = obj["key"]
            assert key in score_table, f"key: {key} not found in score file"
            if str(obj["txt"]).upper() == keyword:
                keyword_table[key] = score_table[key]
            else:
                filler_table[key] = score_table[key]
                filler_duration += float(obj["duration"])
    return keyword_table, filler_table, filler_duration


def compute_det(
    keyword_table: Dict[str, List[float]],
    filler_table: Dict[str, List[float]],
    filler_duration: float,
    step: float = 0.01,
    window_shift: int = 50,
) -> List[Tuple[float, float, float]]:
    """-> [(threshold, false_alarms_per_hour, false_reject_rate)]."""
    keyword_max = np.asarray(
        [max(scores) if scores else 0.0 for scores in keyword_table.values()]
    )
    results = []
    threshold = 0.0
    while threshold <= 1.0:
        if len(keyword_max):
            frr = float(np.mean(keyword_max < threshold))
        else:
            frr = 0.0
        num_fa = 0
        for scores in filler_table.values():
            i = 0
            n = len(scores)
            while i < n:
                if scores[i] >= threshold:
                    num_fa += 1
                    i += window_shift
                else:
                    i += 1
        num_fa = max(num_fa, 1e-6)
        fa_per_hour = (
            num_fa / (filler_duration / 3600.0) if filler_duration else 0.0
        )
        results.append((threshold, fa_per_hour, frr))
        threshold += step
    return results


def write_stats_file(
    results: Sequence[Tuple[float, float, float]], stats_file: str
) -> None:
    with open(stats_file, "w", encoding="utf8") as fout:
        for threshold, fa_per_hour, frr in results:
            fout.write(f"{threshold:.6f} {fa_per_hour:.6f} {frr:.6f}\n")


def frr_at_fa_per_hour(
    results: Sequence[Tuple[float, float, float]], target_fa_per_hour: float
) -> float:
    """Headline metric: smallest FRR whose FA/h <= target (the DET
    operating point reported in the reference READMEs)."""
    eligible = [r for r in results if r[1] <= target_fa_per_hour]
    if not eligible:
        return 1.0
    return min(r[2] for r in eligible)


def import_pyplot():
    """``matplotlib.pyplot`` on the Agg backend, imported here and only
    here for the DET plots (ROADMAP C.29: matplotlib and pypinyin are
    optional and imported inside the plotting functions).  Raises
    ``ImportError`` naming the ``plot`` extra where matplotlib is
    missing."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the DET plot needs matplotlib, the optional "
                          "'plot' extra: pip install 'wekws_tpu[plot]'") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
