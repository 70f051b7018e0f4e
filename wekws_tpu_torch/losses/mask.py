"""Sequence padding masks: ``True`` marks PADDING positions, as in
wekws_tpu/losses/mask.py and the reference."""

import torch


def padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool, True where t >= length."""
    seq = torch.arange(max_len, device=lengths.device,
                       dtype=lengths.dtype)[None, :]
    return seq >= lengths[:, None]
