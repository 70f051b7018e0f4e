"""Edit-distance calculator with per-token statistics.

The port's own numpy-only copy of wekws_tpu/decode/calculator.py (the
reference wekws Calculator's counters): Levenshtein alignment with unit
costs, accumulating cor/sub/ins/del per token across calls, plus
``overall()`` and ``cluster()`` aggregation, as a numpy DP and
backtrace.
"""

from typing import Dict, List, Sequence

import numpy as np


class Calculator:
    def __init__(self):
        self.data: Dict[str, Dict[str, int]] = {}

    def _ensure(self, token: str):
        if token and token not in self.data:
            self.data[token] = {
                "all": 0, "cor": 0, "sub": 0, "ins": 0, "del": 0,
            }

    def calculate(self, lab: Sequence[str], rec: Sequence[str]) -> dict:
        lab = [t for t in lab]
        rec = [t for t in rec]
        for t in lab + rec:
            self._ensure(t)
        n, m = len(lab), len(rec)
        dist = np.zeros((n + 1, m + 1), np.int32)
        dist[:, 0] = np.arange(n + 1)
        dist[0, :] = np.arange(m + 1)
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                same = lab[i - 1] == rec[j - 1]
                dist[i, j] = min(
                    dist[i - 1, j] + 1,            # deletion
                    dist[i, j - 1] + 1,            # insertion
                    dist[i - 1, j - 1] + (0 if same else 1),
                )
        result = {
            "lab": [], "rec": [], "all": 0, "cor": 0, "sub": 0,
            "ins": 0, "del": 0,
        }
        i, j = n, m
        while i > 0 or j > 0:
            if i > 0 and j > 0 and lab[i - 1] == rec[j - 1] and (
                dist[i, j] == dist[i - 1, j - 1]
            ):
                kind = "cor"
            elif i > 0 and j > 0 and dist[i, j] == dist[i - 1, j - 1] + 1:
                kind = "sub"
            elif i > 0 and dist[i, j] == dist[i - 1, j] + 1:
                kind = "del"
            else:
                kind = "ins"
            if kind in ("cor", "sub"):
                token = lab[i - 1]
                if token:
                    self.data[token]["all"] += 1
                    self.data[token][kind] += 1
                    result["all"] += 1
                    result[kind] += 1
                result["lab"].insert(0, lab[i - 1])
                result["rec"].insert(0, rec[j - 1])
                i, j = i - 1, j - 1
            elif kind == "del":
                token = lab[i - 1]
                if token:
                    self.data[token]["all"] += 1
                    self.data[token]["del"] += 1
                    result["all"] += 1
                    result["del"] += 1
                result["lab"].insert(0, lab[i - 1])
                result["rec"].insert(0, "")
                i -= 1
            else:  # ins
                token = rec[j - 1]
                if token:
                    self.data[token]["ins"] += 1
                    result["ins"] += 1
                result["lab"].insert(0, "")
                result["rec"].insert(0, rec[j - 1])
                j -= 1
        return result

    def overall(self) -> dict:
        return self.cluster(list(self.data.keys()))

    def cluster(self, tokens: List[str]) -> dict:
        result = {"all": 0, "cor": 0, "sub": 0, "ins": 0, "del": 0}
        for token in tokens:
            if token in self.data:
                for k in result:
                    result[k] += self.data[token][k]
        return result

    def keys(self) -> List[str]:
        return list(self.data.keys())
