"""Global CMVN statistics loaders (numpy copy of
wekws_tpu/frontend/cmvn.py).

Reference wekws semantics (utils/cmvn.py, model/cmvn.py): JSON stats
files hold raw {mean_stat, var_stat, frame_num} accumulators;
Kaldi-text files hold AddShift/Rescale(/Splice) components.
Application is ``(x - mean) * istd`` with a 1e-20 variance floor.
"""

import json
import re
from typing import Tuple

import numpy as np


def load_cmvn_json(path: str) -> np.ndarray:
    """JSON accumulator file -> np.ndarray [2, D] of (mean, inv_std)."""
    with open(path, "r", encoding="utf8") as f:
        stats = json.load(f)
    count = stats["frame_num"]
    mean = np.asarray(stats["mean_stat"], np.float64) / count
    var = np.asarray(stats["var_stat"], np.float64) / count - mean * mean
    var = np.maximum(var, 1.0e-20)
    istd = 1.0 / np.sqrt(var)
    return np.stack([mean, istd]).astype(np.float64)


def _bracketed_floats(line: str) -> list:
    inner = re.findall(r"[\[](.*?)[\]]", line)[0]
    return [float(s) for s in inner.strip().split()]


def load_cmvn_kaldi(path: str) -> np.ndarray:
    """Kaldi-text nnet file with AddShift/Rescale(/Splice) components.

    AddShift holds negated means; Rescale holds inverse stds; Splice
    (if present) tiles the stats across the context-expanded feature.
    """
    means = None
    istd = None
    copy_times = 1
    with open(path, encoding="utf8") as f:
        lines = f.readlines()
    for idx, line in enumerate(lines):
        if "AddShift" in line:
            segs = line.strip().split(" ")
            assert len(segs) == 3
            vals = _bracketed_floats(lines[idx + 1])
            means = [-v for v in vals]
            assert len(means) == int(segs[1])
        elif "Rescale" in line:
            segs = line.strip().split(" ")
            assert len(segs) == 3
            istd = _bracketed_floats(lines[idx + 1])
            assert len(istd) == int(segs[1])
        elif "Splice" in line:
            segs = line.strip().split(" ")
            assert len(segs) == 3
            splice = lines[idx + 1]
            inner = re.findall(r"[\[](.*?)[\]]", splice)[0]
            n_ctx = len(inner.strip().split())
            assert n_ctx * int(segs[2]) == int(segs[1])
            copy_times = n_ctx
    cmvn = np.array([means, istd], np.float64)
    return np.tile(cmvn, (1, copy_times))


def load_cmvn(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Dispatch on filename like the reference factory: 'kaldi' in the
    path selects the Kaldi-text parser.  Returns (mean, istd) float32."""
    if "kaldi" in path:
        cmvn = load_cmvn_kaldi(path)
    else:
        cmvn = load_cmvn_json(path)
    return cmvn[0].astype(np.float32), cmvn[1].astype(np.float32)
