"""Preprocessing layers (idim -> hdim), rate 1.

``LinearSubsampling1`` keeps the reference's ``out = Sequential(Linear,
ReLU)`` so its weights load as ``preprocessing.out.0.{weight,bias}``;
``Conv1dSubsampling1`` its ``out = Sequential(Conv1d, BatchNorm1d,
ReLU)`` (``preprocessing.out.0`` the conv, ``preprocessing.out.1`` the
BatchNorm).
"""

import torch
from torch import nn

from wekws_tpu_torch.models.layers import BatchNorm, Conv1d


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


class Conv1dSubsampling1(nn.Module):
    """Causal Conv1d(k=3) after two zero frames, BatchNorm, ReLU; no
    rate change.  Port of wekws_tpu/models/subsampling.py's: the
    BatchNorm is flax's (momentum 0.9 there, 0.1 here; eps 1e-5; biased
    batch variance in the running average).  Like the JAX module it
    keeps no cache: every call, a streaming chunk too, starts from two
    zero frames."""

    subsampling_rate = 1

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.out = nn.Sequential(Conv1d(idim, odim, 3), BatchNorm(odim),
                                 nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn, relu = self.out
        return relu(bn(conv(x, left_pad=2)))
