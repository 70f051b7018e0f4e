#!/usr/bin/env python3
"""Summarize the aug-vs-clean DET comparison on the PyTorch/CUDA port:
FRR at fixed FA/h on the clean and noisy test splits, from the stats
files run_torch.sh wrote (through the port's operating-point helper,
wekws_tpu_torch.eval.frr_at_fa_per_hour).  The table of report.py,
character for character.

    python local/report_torch.py exp/torch_ds_tcn_aug exp/torch_ds_tcn_clean
"""

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from wekws_tpu_torch.eval import frr_at_fa_per_hour  # noqa: E402


def load_stats(path):
    with open(path) as f:
        return [tuple(float(x) for x in line.split()) for line in f]


def main(argv=None):
    dirs = sys.argv[1:] if argv is None else argv
    fa = 2.0
    print(f"{'model':14s} {'clean FRR':>10s} {'noisy FRR':>10s}"
          f"   (@ FA<={fa}/h)")
    for d in dirs:
        clean = frr_at_fa_per_hour(load_stats(f"{d}/stats_test.txt"), fa)
        noisy = frr_at_fa_per_hour(
            load_stats(f"{d}/stats_test_noisy.txt"), fa
        )
        name = d.rstrip("/").split("/")[-1]
        print(f"{name:14s} {clean:10.4f} {noisy:10.4f}")


if __name__ == "__main__":
    main()
