"""Output heads.

Port of wekws_tpu/models/classifier.py.  Names follow the reference
wekws: ``classifier.linear`` for the wake-word Linear head,
``classifier.classifier.{0,3}`` for the MLP (Linear -> ReLU -> Dropout
-> Linear) that the element, global and last heads apply per frame, to
the length-masked mean over time, or to the last valid frame.  Every
head takes the frame ``lengths`` (the per-frame ones ignore them).
"""

from typing import Optional

import torch
from torch import nn


class MLPHead(nn.Sequential):
    """Linear(hdim, 64) -> ReLU -> Dropout -> Linear(64, odim)."""

    def __init__(self, hdim: int, output_dim: int, dropout: float = 0.1,
                 hidden: int = 64):
        super().__init__(nn.Linear(hdim, hidden), nn.ReLU(),
                         nn.Dropout(dropout), nn.Linear(hidden, output_dim))


class LinearClassifier(nn.Module):
    """Bare per-frame Linear head (wake-word default)."""

    def __init__(self, hdim: int, output_dim: int):
        super().__init__()
        self.linear = nn.Linear(hdim, output_dim)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.linear(x)


class ElementClassifier(nn.Module):
    """Per-frame MLP."""

    def __init__(self, hdim: int, output_dim: int, dropout: float = 0.1):
        super().__init__()
        self.classifier = MLPHead(hdim, output_dim, dropout)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.classifier(x)


class GlobalClassifier(nn.Module):
    """Mean over time, then the MLP: (B, T, H) -> (B, K).  With
    ``lengths`` the padded frames are left out of the mean (a length of
    0 divides by 1)."""

    def __init__(self, hdim: int, output_dim: int, dropout: float = 0.1):
        super().__init__()
        self.classifier = MLPHead(hdim, output_dim, dropout)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if lengths is None:
            pooled = x.mean(dim=1)
        else:
            t = x.shape[1]
            mask = (torch.arange(t, device=x.device)[None, :]
                    < lengths[:, None]).to(x.dtype)
            pooled = (x * mask[:, :, None]).sum(dim=1) / torch.clamp(
                mask.sum(dim=1, keepdim=True), min=1.0)
        return self.classifier(pooled)


class LastClassifier(nn.Module):
    """The MLP on the last valid frame: (B, T, H) -> (B, K).  Without
    ``lengths`` the last frame; a length of 0 reads frame 0."""

    def __init__(self, hdim: int, output_dim: int, dropout: float = 0.1):
        super().__init__()
        self.classifier = MLPHead(hdim, output_dim, dropout)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if lengths is None:
            last = x[:, -1, :]
        else:
            idx = torch.clamp(lengths.to(torch.int64) - 1, 0, x.shape[1] - 1)
            last = x[torch.arange(x.shape[0], device=x.device), idx]
        return self.classifier(last)


class IdentityClassifier(nn.Module):
    """Pass-through (CTC models where the backbone emits logits)."""

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return x
