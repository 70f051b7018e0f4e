"""Preprocessing layers (idim -> hdim), rate 1.

``LinearSubsampling1`` keeps the reference's ``out = Sequential(Linear,
ReLU)`` so its weights load as ``preprocessing.out.0.{weight,bias}``.
"""

import torch
from torch import nn


class NoSubsampling(nn.Module):
    subsampling_rate = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class LinearSubsampling1(nn.Module):
    """Linear + ReLU, no rate change."""

    subsampling_rate = 1

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.out = nn.Sequential(nn.Linear(idim, odim), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(x)
