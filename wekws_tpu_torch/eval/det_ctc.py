"""DET computation for the CTC path.

Port of wekws_tpu/eval/det_ctc.py (the reference wekws's
bin/compute_det_ctc.py): keyword or filler membership by a
space-normalised substring match of the transcript, the detection
confidence from the score file, FRR and FA/h swept at ``step`` (default
0.001), and the overlaid DET plot (``plot_det_curves``; matplotlib and
pypinyin are optional and imported inside the functions, ROADMAP C.29).
"""

import json
from typing import Dict, List, Sequence, Tuple

from wekws_tpu_torch.eval.det import import_pyplot
from wekws_tpu_torch.text.tokenizer import split_mixed_label


def space_mixed_label(input_str: str) -> str:
    return " ".join(split_mixed_label(input_str))


def load_label_and_score_ctc(
    keywords_list: Sequence[str],
    label_file: str,
    score_file: str,
) -> Dict[str, dict]:
    """-> {keyword: {keyword_table, keyword_duration, filler_table,
    filler_duration}} with confidences (-1.0 = not detected)."""
    score_table: Dict[str, dict] = {}
    with open(score_file, "r", encoding="utf8") as fin:
        for line in fin:
            arr = line.strip().split()
            if not arr:
                continue
            key = arr[0]
            if key in score_table:
                continue
            if len(arr) >= 4 and arr[1] == "detected":
                score_table[key] = {
                    "kw": space_mixed_label(arr[2]),
                    "confi": float(arr[3]),
                }
            else:
                score_table[key] = {"kw": "unknown", "confi": -1.0}

    table: Dict[str, dict] = {}
    for keyword in keywords_list:
        table[space_mixed_label(keyword)] = {
            "keyword_table": {},
            "keyword_duration": 0.0,
            "filler_table": {},
            "filler_duration": 0.0,
        }

    with open(label_file, "r", encoding="utf8") as fin:
        for line in fin:
            obj = json.loads(line.strip())
            key = obj["key"]
            txt = " " + space_mixed_label(str(obj["txt"])) + " "
            duration = float(obj["duration"])
            if key not in score_table:
                raise KeyError(f"{key} missing from score file")
            for keyword in table:
                entry = table[keyword]
                if txt.find(" " + keyword + " ") != -1:
                    entry["keyword_table"][key] = (
                        score_table[key]["confi"]
                        if keyword == score_table[key]["kw"]
                        else -1.0
                    )
                    entry["keyword_duration"] += duration
                else:
                    entry["filler_table"][key] = (
                        score_table[key]["confi"]
                        if keyword == score_table[key]["kw"]
                        else -1.0
                    )
                    entry["filler_duration"] += duration
    return table


def compute_det_ctc(
    entry: dict, step: float = 0.001
) -> List[Tuple[float, float, float]]:
    """-> [(threshold, fa_per_hour, frr)] for one keyword's tables."""
    keyword_num = max(len(entry["keyword_table"]), 1)
    filler_hours = entry["filler_duration"] / 3600.0
    results = []
    threshold = 0.0
    while threshold <= 1.0:
        num_false_reject = sum(
            1
            for confi in entry["keyword_table"].values()
            if confi < threshold
        )
        num_false_alarm = sum(
            1
            for confi in entry["filler_table"].values()
            if confi >= threshold
        )
        frr = num_false_reject / keyword_num
        fa = max(num_false_alarm, 1e-6)
        fa_per_hour = fa / filler_hours if filler_hours else 0.0
        results.append((threshold, fa_per_hour, frr))
        threshold += step
    return results


def romanize(label: str) -> str:
    """Legend label for DET plots: romanize CJK via pypinyin when the
    package is available (reference compute_det_ctc.py:147), else keep
    the raw label (matplotlib CJK font support varies)."""
    try:
        import pypinyin

        return "".join(pypinyin.lazy_pinyin(label))
    except ImportError:
        return label


def plot_det_curves(
    stats_dir: str,
    figure_file: str,
    xlim: float = 5,
    x_step: float = 1,
    ylim: float = 35,
    y_step: float = 5,
) -> None:
    """Overlay every ``stats.<keyword>.txt`` in ``stats_dir`` on one
    DET figure (reference compute_det_ctc.py:138-160 semantics).  Raises
    ``ImportError`` naming the ``plot`` extra without matplotlib."""
    import glob
    import os

    import numpy as np

    plt = import_pyplot()
    plt.figure(dpi=200)
    plt.rcParams["xtick.direction"] = "in"
    plt.rcParams["ytick.direction"] = "in"
    plt.rcParams["font.size"] = 12
    for path in sorted(glob.glob(os.path.join(stats_dir, "*stats*.txt"))):
        label = romanize(os.path.basename(path).split(".")[1])
        rows = []
        with open(path, encoding="utf8") as f:
            for line in f:
                _thr, fa, frr = line.split()
                rows.append((float(fa), float(frr) * 100.0))
        values = np.asarray(list(reversed(rows)))
        plt.plot(values[:, 0], values[:, 1], label=label)
    plt.xlim([0, xlim])
    plt.ylim([0, ylim])
    plt.xticks(np.arange(0, xlim + x_step, x_step))
    plt.yticks(np.arange(0, ylim + y_step, y_step))
    plt.xlabel("False Alarm Per Hour")
    plt.ylabel("False Rejection Rate (%)")
    plt.grid(linestyle="--")
    plt.legend(loc="best", fontsize=6)
    plt.savefig(figure_file)
    plt.close()
