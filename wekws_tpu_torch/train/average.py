"""Checkpoint averaging over port checkpoints.

Port of wekws_tpu/train/average.py: pick the top-N checkpoints by
sidecar ``cv_loss`` (or the last N by epoch) and average their floating
entries in float64.  BatchNorm running statistics and
``num_batches_tracked`` are taken from the first picked checkpoint, as
the JAX package keeps the first checkpoint's ``batch_stats`` (the
reference wekws averages them too).
"""

import glob
import os
from typing import List, Tuple

import numpy as np
import torch

from wekws_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_checkpoint_info,
    save_checkpoint,
)

_BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def find_checkpoints(model_dir: str, num: int,
                     val_best: bool = True) -> List[str]:
    paths = sorted(
        p for p in glob.glob(os.path.join(model_dir, "*.pt"))
        if os.path.basename(p)[0].isdigit() and not os.path.islink(p))
    if val_best:
        scored: List[Tuple[float, str]] = []
        for p in paths:
            info = load_checkpoint_info(p)
            if "cv_loss" in info and np.isfinite(info["cv_loss"]):
                scored.append((float(info["cv_loss"]), p))
        scored.sort(key=lambda x: x[0])
        return [p for _, p in scored[:num]]
    paths.sort(key=lambda p: int(os.path.basename(p).split(".")[0]))
    return paths[-num:]


def average_checkpoints(model_dir: str, dst_path: str, num: int,
                        val_best: bool = True) -> List[str]:
    picked = find_checkpoints(model_dir, num, val_best)
    if not picked:
        raise FileNotFoundError(f"no checkpoints found in {model_dir}")
    first = load_checkpoint(picked[0])
    averaged = {k: k.rsplit(".", 1)[-1] not in _BN_BUFFERS
                and v.is_floating_point() for k, v in first.items()}
    acc = {k: v.to(torch.float64) for k, v in first.items() if averaged[k]}
    for p in picked[1:]:
        state = load_checkpoint(p)
        for k in acc:
            acc[k] += state[k].to(torch.float64)
    n = len(picked)
    out = {k: (acc[k] / n).to(v.dtype) if averaged[k] else v
           for k, v in first.items()}
    save_checkpoint(dst_path, out)
    return picked
