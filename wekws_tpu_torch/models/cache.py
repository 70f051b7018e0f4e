"""Streaming-cache helpers.

Port of wekws_tpu/models/cache.py.  A backbone's module cache is a tuple
of per-layer left-context tensors ``(B, pad_i, D)`` (or the ``(B, L, H)``
hidden state of a GRU).  For the single-tensor runtime interface (one
cache tensor per step) these helpers pack the tuple into one
time-concatenated tensor and unpack it again.
"""

from typing import Sequence, Tuple

import torch


def concat_cache(cache) -> torch.Tensor:
    """Tuple of (B, pad_i, D) -> (B, sum(pad_i), D).

    A GRU's hidden state (B, L, H) passes through unchanged.
    """
    if isinstance(cache, torch.Tensor):
        return cache
    return torch.cat(list(cache), dim=1)


def split_cache(packed: torch.Tensor,
                paddings: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """(B, sum(pad_i), D) -> tuple of (B, pad_i, D) views."""
    out = []
    offset = 0
    for p in paddings:
        out.append(packed[:, offset:offset + p, :])
        offset += p
    return tuple(out)


def cache_shape(cache):
    """Total (frames, dim) footprint of a cache (for metadata)."""
    if isinstance(cache, torch.Tensor):
        return int(cache.shape[1]), int(cache.shape[2])
    frames = sum(int(c.shape[1]) for c in cache)
    dim = int(cache[0].shape[2]) if len(cache) else 0
    return frames, dim
