"""Checkpoint-averaging CLI.

Port of wekws_tpu/bin/average_model.py (the reference wekws's
bin/average_model.py) over the port's ``.pt`` checkpoints.
"""

import argparse

from wekws_tpu_torch.device import resolve_device
from wekws_tpu_torch.train import average_checkpoints


def main(argv=None):
    parser = argparse.ArgumentParser(description="average model")
    parser.add_argument("--dst_model", required=True)
    parser.add_argument("--src_path", required=True)
    parser.add_argument("--num", default=5, type=int)
    parser.add_argument("--val_best", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    picked = average_checkpoints(
        args.src_path, args.dst_model, args.num, args.val_best
    )
    print(f"averaged {len(picked)} checkpoints -> {args.dst_model}")
    for p in picked:
        print(f"  {p}")
    return picked


if __name__ == "__main__":
    main()
