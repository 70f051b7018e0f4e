"""Per-frame output heads the fused serving path supports.

Names follow the reference: ``classifier.linear`` for the wake-word
Linear head, ``classifier.classifier.{0,3}`` for the per-frame MLP
(Linear -> ReLU -> Dropout -> Linear).
"""

import torch
from torch import nn


class LinearClassifier(nn.Module):
    """Bare per-frame Linear head (wake-word default)."""

    def __init__(self, hdim: int, output_dim: int):
        super().__init__()
        self.linear = nn.Linear(hdim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class ElementClassifier(nn.Module):
    """Per-frame MLP: Linear(hdim, 64) -> ReLU -> Dropout -> Linear."""

    def __init__(self, hdim: int, output_dim: int, dropout: float = 0.1,
                 hidden: int = 64):
        super().__init__()
        self.classifier = nn.Sequential(
            nn.Linear(hdim, hidden), nn.ReLU(), nn.Dropout(dropout),
            nn.Linear(hidden, output_dim),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(x)


class IdentityClassifier(nn.Module):
    """Pass-through (CTC models where the backbone emits logits)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x
