"""Checkpoints with sidecar metadata.

Port of wekws_tpu/train/checkpoint.py.  A port checkpoint is
``torch.save`` of the model's state_dict (reference wekws parameter
names) at ``<epoch>.pt``, plus a sidecar ``<epoch>.yaml``
{epoch, lr, cv_loss}; ``final.pt`` links the last one.  Loading the
JAX package's flax-msgpack checkpoints is not ported yet.
"""

import os
from typing import Dict, Optional

import torch
import yaml


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    info: Optional[Dict] = None) -> None:
    """Write ``state_dict`` (copied to the CPU) and, with ``info``,
    the ``.yaml`` sidecar beside it."""
    cpu = {k: v.detach().to("cpu") for k, v in state_dict.items()}
    torch.save(cpu, path)
    if info is not None:
        with open(os.path.splitext(path)[0] + ".yaml", "w") as f:
            yaml.dump({k: float(v) for k, v in info.items()}, f)


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a port checkpoint, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint_info(path: str) -> Dict:
    side = os.path.splitext(path)[0] + ".yaml"
    if os.path.exists(side):
        with open(side) as f:
            return yaml.safe_load(f) or {}
    return {}


def link_final(model_dir: str, epoch: int, name: str = "final.pt") -> None:
    final = os.path.join(model_dir, name)
    if os.path.lexists(final):
        os.remove(final)
    os.symlink(f"{epoch}.pt", final)
