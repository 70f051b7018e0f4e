"""Temporal convolutional network (TCN / DS-TCN) backbone.

Port of wekws_tpu/models/tcn.py with the reference wekws module names
(``network.{i}.cnn.{0,1,3,4}``): a streaming causal dilated 1-D conv
stack with residual connections, feature-last ``(B, T, C)``.

* block i has dilation ``2**i`` and a cache of ``(K - 1) * 2**i``
  input frames, ``(B, pad_i, C)``; the cache is a tuple over blocks.
  ``None`` runs the whole utterance with zero left context as implicit
  padding; a streaming chunk prepends its cache and keeps the last
  ``pad_i`` input frames;
* ``CnnBlock``:   Conv1d(K, dil) -> BN -> ReLU -> Dropout;  y + x
* ``DsCnnBlock``: depthwise(K, dil) -> BN -> ReLU -> 1x1 -> BN -> ReLU
  -> Dropout;  y + x  (no activation after the residual add).

The full ``(C, C, K)`` convolution of ``CnnBlock`` is K shifted float32
matmuls (``layers.Conv1d``), not ``F.conv1d``: cuDNN would run a
float32 convolution in TF32 by default.

The JAX package's knobs: ``dtype`` (the convolutions' compute dtype),
``bn_dtype`` and ``ghost_bn`` (``layers.batch_norm``); the residual adds
``x`` in the block output's dtype and ``TCN`` returns float32.  JAX's
TCN has no ``remat``.
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from wekws_tpu_torch.models.layers import (
    Conv1d,
    DepthwiseConv1d,
    PointwiseConv1d,
    batch_norm,
    float_out,
)


class _Block(nn.Module):
    """Cache handling and the residual shared by both block kinds;
    ``self.cnn`` keeps the reference's ``nn.Sequential`` indices."""

    def __init__(self, channel: int, kernel_size: int, dilation: int):
        super().__init__()
        self.channel = channel
        self.kernel_size = kernel_size
        self.dilation = dilation

    @property
    def padding(self) -> int:
        return (self.kernel_size - 1) * self.dilation

    def _body(self, y: torch.Tensor, left_pad: int) -> torch.Tensor:
        raise NotImplementedError

    def forward(
        self, x: torch.Tensor, cache: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if cache is None:
            y, new_cache, left_pad = x, None, self.padding
        else:
            y = torch.cat([cache, x], dim=1)
            new_cache = y[:, y.shape[1] - self.padding:, :]
            left_pad = 0
        y = self._body(y, left_pad)
        return y + x.to(y.dtype), new_cache


class CnnBlock(_Block):
    def __init__(self, channel: int, kernel_size: int, dilation: int,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None,
                 ghost_bn: int = 0, bn_dtype: Optional[torch.dtype] = None):
        super().__init__(channel, kernel_size, dilation)
        self.cnn = nn.Sequential(
            Conv1d(channel, channel, kernel_size, dilation, dtype=dtype),
            batch_norm(channel, ghost_bn, bn_dtype), nn.ReLU(),
            nn.Dropout(dropout))

    def _body(self, y, left_pad):
        conv, bn, relu, drop = self.cnn
        return drop(relu(bn(conv(y, left_pad))))


class DsCnnBlock(_Block):
    """Depthwise-separable variant."""

    def __init__(self, channel: int, kernel_size: int, dilation: int,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None,
                 ghost_bn: int = 0, bn_dtype: Optional[torch.dtype] = None):
        super().__init__(channel, kernel_size, dilation)
        self.cnn = nn.Sequential(
            DepthwiseConv1d(channel, kernel_size, dilation, dtype=dtype),
            batch_norm(channel, ghost_bn, bn_dtype), nn.ReLU(),
            PointwiseConv1d(channel, channel, dtype=dtype),
            batch_norm(channel, ghost_bn, bn_dtype), nn.ReLU(),
            nn.Dropout(dropout))

    def _body(self, y, left_pad):
        dw, dw_bn, relu, pw, pw_bn, relu2, drop = self.cnn
        y = relu(dw_bn(dw(y, left_pad)))
        return drop(relu2(pw_bn(pw(y))))


class TCN(nn.Module):
    def __init__(self, num_layers: int, channel: int, kernel_size: int,
                 dropout: float = 0.1, ds: bool = False,
                 dtype: Optional[torch.dtype] = None, ghost_bn: int = 0,
                 bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        self.channel = channel
        self.kernel_size = kernel_size
        self.ds = ds
        block_cls = DsCnnBlock if ds else CnnBlock
        self.network = nn.ModuleList(
            block_cls(channel, kernel_size, 2 ** i, dropout, dtype, ghost_bn,
                      bn_dtype)
            for i in range(num_layers))

    @property
    def paddings(self) -> Sequence[int]:
        return tuple((self.kernel_size - 1) * 2 ** i
                     for i in range(self.num_layers))

    @property
    def padding(self) -> int:
        """Total receptive-field left context (== cache frames)."""
        return sum(self.paddings)

    def init_cache(self, batch_size: int, device="cpu"):
        return tuple(
            torch.zeros((batch_size, p, self.channel), dtype=torch.float32,
                        device=device)
            for p in self.paddings)

    def forward(self, x: torch.Tensor, cache=None):
        if cache is None:
            cache = (None,) * self.num_layers
        new_caches = []
        for block, c in zip(self.network, cache):
            x, c = block(x, c)
            new_caches.append(c)
        return float_out(x), tuple(new_caches)
