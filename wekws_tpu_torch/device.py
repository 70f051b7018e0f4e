"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; a
request for CUDA on a machine without a usable GPU raises instead of
quietly running on the CPU.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU"
        )
    return dev
