"""Global CMVN: ``(x - mean) * istd`` with precomputed statistics,
held as buffers named like the reference (``global_cmvn.mean``,
``global_cmvn.istd``)."""

import torch
from torch import nn


class GlobalCMVN(nn.Module):
    def __init__(self, mean, istd, norm_var: bool = True):
        super().__init__()
        self.norm_var = norm_var
        self.register_buffer("mean", torch.as_tensor(mean, dtype=torch.float32))
        self.register_buffer("istd", torch.as_tensor(istd, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x - self.mean
        if self.norm_var:
            x = x * self.istd
        return x
