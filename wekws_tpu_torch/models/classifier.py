"""Output heads.

Port of wekws_tpu/models/classifier.py.  Names follow the reference
wekws: ``classifier.linear`` for the wake-word Linear head,
``classifier.classifier.{0,3}`` for the MLP (Linear -> ReLU -> Dropout
-> Linear) that the element, global and last heads apply per frame, to
the length-masked mean over time, or to the last valid frame.  Every
head takes the frame ``lengths`` (the per-frame ones ignore them).  A
pooled head's ``pool`` (``global_pool``, ``last_frame``) is what the
fused serving runner applies after the backbone kernel.
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


def global_pool(x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, H) -> (B, H): the mean over each row's first ``lengths``
    frames (a length of 0 divides by 1); without ``lengths`` over all."""
    if lengths is None:
        return x.mean(dim=1)
    t = x.shape[1]
    mask = (torch.arange(t, device=x.device)[None, :]
            < lengths[:, None]).to(x.dtype)
    return (x * mask[:, :, None]).sum(dim=1) / torch.clamp(
        mask.sum(dim=1, keepdim=True), min=1.0)


def last_frame(x: torch.Tensor,
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, H) -> (B, H): each row's last valid frame (a length of 0
    reads frame 0); without ``lengths`` the last frame."""
    if lengths is None:
        return x[:, -1, :]
    idx = torch.clamp(lengths.to(torch.int64) - 1, 0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


class GlobalClassifier(nn.Module):
    """Mean over time, then the MLP: (B, T, H) -> (B, K).  With
    ``lengths`` the padded frames are left out of the mean (a length of
    0 divides by 1)."""

    def __init__(self, hdim: int, output_dim: int, dropout: float = 0.1):
        super().__init__()
        self.classifier = MLPHead(hdim, output_dim, dropout)

    pool = staticmethod(global_pool)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.classifier(self.pool(x, lengths))


class LastClassifier(nn.Module):
    """The MLP on the last valid frame: (B, T, H) -> (B, K).  Without
    ``lengths`` the last frame; a length of 0 reads frame 0."""

    def __init__(self, hdim: int, output_dim: int, dropout: float = 0.1):
        super().__init__()
        self.classifier = MLPHead(hdim, output_dim, dropout)

    pool = staticmethod(last_frame)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.classifier(self.pool(x, lengths))


class IdentityClassifier(nn.Module):
    """Pass-through (CTC models where the backbone emits logits)."""

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return x
