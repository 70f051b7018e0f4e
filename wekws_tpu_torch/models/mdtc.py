"""Multi-scale Depthwise Temporal Convolution (MDTC) backbone.

Port of wekws_tpu/models/mdtc.py with the reference wekws module
names (``preprocessor``, ``blocks.{s}.res_blocks.{i}``, and inside a
block ``conv1.{conv,bn,pointwise}``, ``bn1``, ``conv2``, ``bn2``):

* ``TCNBlock``: DS dilated conv (depthwise -> BN -> pointwise), then
  BN -> ReLU -> 1x1 conv -> BN, residual add when channels match,
  final ReLU;
* ``TCNStack``: blocks with dilations ``2^0 .. 2^(stack_size-1)``;
* ``MDTC``: a dilation-1 preprocessor block followed by an extra ReLU,
  then ``stack_num`` stacks whose outputs are summed.  Causal only.

The cache is a tuple over all blocks in network order, each
``(B, (K-1)*d, C)``; ``None`` runs the whole utterance with zero left
context as implicit padding.
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from wekws_tpu_torch.models.layers import (
    BatchNorm,
    DepthwiseConv1d,
    PointwiseConv1d,
)


class DSDilatedConv1d(nn.Module):
    """Dilated depthwise-separable conv: DW conv -> BN -> pointwise."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, dilation: int = 1):
        super().__init__()
        self.conv = DepthwiseConv1d(in_channels, kernel_size, dilation)
        self.bn = BatchNorm(in_channels)
        self.pointwise = PointwiseConv1d(in_channels, out_channels)

    def forward(self, x: torch.Tensor, left_pad: int = 0) -> torch.Tensor:
        return self.pointwise(self.bn(self.conv(x, left_pad)))


class TCNBlock(nn.Module):
    def __init__(self, in_channels: int, res_channels: int,
                 kernel_size: int, dilation: int):
        super().__init__()
        self.in_channels = in_channels
        self.res_channels = res_channels
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.conv1 = DSDilatedConv1d(in_channels, res_channels, kernel_size,
                                     dilation)
        self.bn1 = BatchNorm(res_channels)
        self.conv2 = PointwiseConv1d(res_channels, res_channels)
        self.bn2 = BatchNorm(res_channels)

    @property
    def padding(self) -> int:
        return (self.kernel_size - 1) * self.dilation

    def forward(
        self, x: torch.Tensor, cache: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if cache is None:
            y = self.conv1(x, left_pad=self.padding)
            new_cache = None
        else:
            y = torch.cat([cache, x], dim=1)
            new_cache = y[:, y.shape[1] - self.padding:, :]
            y = self.conv1(y)
        y = torch.relu(self.bn1(y))
        y = self.bn2(self.conv2(y))
        if self.in_channels == self.res_channels:
            y = y + x
        return torch.relu(y), new_cache


class TCNStack(nn.Module):
    def __init__(self, channels: int, stack_size: int, kernel_size: int):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            TCNBlock(channels, channels, kernel_size, 2 ** i)
            for i in range(stack_size)
        )


class MDTC(nn.Module):
    def __init__(self, stack_num: int, stack_size: int, in_channels: int,
                 res_channels: int, kernel_size: int, causal: bool = True):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("MDTC kernel_size must be odd")
        if not causal:
            raise ValueError("only causal MDTC is supported")
        self.stack_num = stack_num
        self.stack_size = stack_size
        self.in_channels = in_channels
        self.res_channels = res_channels
        self.kernel_size = kernel_size
        self.preprocessor = TCNBlock(in_channels, res_channels, kernel_size,
                                     1)
        self.blocks = nn.ModuleList(
            TCNStack(res_channels, stack_size, kernel_size)
            for _ in range(stack_num)
        )

    @property
    def block_specs(self) -> Sequence[Tuple[int, int]]:
        """(in_channels, dilation) of every block, network order."""
        specs = [(self.in_channels, 1)]
        for _ in range(self.stack_num):
            for i in range(self.stack_size):
                specs.append((self.res_channels, 2 ** i))
        return tuple(specs)

    @property
    def padding(self) -> int:
        """Receptive field."""
        return sum((self.kernel_size - 1) * d for _, d in self.block_specs)

    def init_cache(self, batch_size: int, device="cpu"):
        return tuple(
            torch.zeros((batch_size, (self.kernel_size - 1) * d, c),
                        dtype=torch.float32, device=device)
            for c, d in self.block_specs
        )

    def forward(self, x: torch.Tensor, cache=None):
        if cache is None:
            cache = (None,) * len(self.block_specs)
        new_caches = []
        y, c = self.preprocessor(x, cache[0])
        y = torch.relu(y)
        new_caches.append(c)
        outputs = None
        idx = 1
        for stack in self.blocks:
            for block in stack.res_blocks:
                y, c = block(y, cache[idx])
                new_caches.append(c)
                idx += 1
            outputs = y if outputs is None else outputs + y
        return outputs, tuple(new_caches)
