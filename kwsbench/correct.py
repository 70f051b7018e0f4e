"""The numbers that decide ``correct``, each beside its limit.

Training (the first three steps of the window's own trainer against the
reference's three from the same weights, rows and draws):

- ``loss_gap``: the largest of the three steps' ``|L - L_ref| / L_ref``,
  ``loss0_gap`` the first step's;
- ``grad_gap``: over the leaves, the worst ``| |g| - |g_ref| |`` of the
  first step's clipped gradient (the program's from Adam's first moment
  after one step, ``mu / (1 - b1)``), over the larger of ``|g_ref|``
  and the median leaf's; ``grad_gap_median`` the median leaf's gap;
- ``change_gap``, ``change_gap_median``: the same of each leaf's change
  over the three steps.

A cell's limits file says which of these decide ``correct``.

A leaf whose reference gradient is under a thousandth of the median
leaf's (a bias in front of a BatchNorm: nought to rounding) is left out
of both, by that rule and not by name: Adam moves it by round-off
alone.
"""

import sys
from typing import Dict, List, Tuple

import torch

LEFT_OUT = 1e-3


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def _median(values: List[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1]
                                                   + v[len(v) // 2])


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> Dict[str, float]:
    pn, rn = _norms({k: prog[k] for k in keep}), _norms({k: ref[k]
                                                        for k in keep})
    med = _median(list(rn.values()))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep}


def train_numbers(prog: dict, ref: dict) -> Tuple[Dict[str, float], dict]:
    """``prog`` and ``ref``: {"loss": [3 floats], "grad0": {leaf: g},
    "change": {leaf: p3 - p0}}.  Returns the numbers and what each
    worst leaf was, with the leaves left out."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    gnorm = _norms(ref["grad0"])
    med = _median(list(gnorm.values()))
    keep = [k for k, v in gnorm.items() if v >= LEFT_OUT * med]
    numbers = {"loss_gap": max(losses), "loss0_gap": losses[0]}
    info = {"left_out": sorted(set(gnorm) - set(keep))}
    for name, key in (("grad", "grad0"), ("change", "change")):
        gaps = leaf_gaps(prog[key], ref[key], keep)
        worst = max(gaps, key=gaps.get)
        numbers[name + "_gap"] = gaps[worst]
        numbers[name + "_gap_median"] = _median(list(gaps.values()))
        info[name + "_leaf"] = worst
    return numbers, info


def judge(numbers: Dict[str, float], limits: Dict[str, float],
          extra_ok: bool = True) -> Tuple[bool, Dict[str, dict]]:
    """Every number within its limit (a NaN is not); the checks as the
    result line gives them, and printed as the last lines of stderr."""
    checks, ok = {}, extra_ok
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
        if not value <= limit:
            ok = False
    return ok, checks


def print_checks(checks: Dict[str, dict]) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
