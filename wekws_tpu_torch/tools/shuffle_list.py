#!/usr/bin/env python3
"""Seeded line shuffle: port of wekws_tpu/tools/shuffle_list.py.

Usage: python -m wekws_tpu_torch.tools.shuffle_list [--seed N] [file|-]
"""

import argparse
import random
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=777)
    parser.add_argument("input", nargs="?", default="-")
    args = parser.parse_args(argv)
    if args.input == "-":
        lines = sys.stdin.readlines()
    else:
        with open(args.input, encoding="utf8") as f:
            lines = f.readlines()
    random.Random(args.seed).shuffle(lines)
    sys.stdout.writelines(lines)


if __name__ == "__main__":
    main()
