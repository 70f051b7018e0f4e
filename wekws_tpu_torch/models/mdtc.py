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

Training: with ``fused_train`` set, a whole-utterance training forward
of a block whose input and output widths match runs through
``ops/fused_mdtc_train.fused_tcn_block_train`` (the eight fused
exact-BN passes) and updates the three BatchNorms' running statistics
from the batch statistics it returns; everything else runs the plain
modules, whose BatchNorms train with the same exact-BN semantics.
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from wekws_tpu_torch.models.layers import (
    BatchNorm,
    DepthwiseConv1d,
    PointwiseConv1d,
)
from wekws_tpu_torch.ops.fused_mdtc_train import fused_tcn_block_train


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
                 kernel_size: int, dilation: int, fused_train: bool = False):
        super().__init__()
        self.fused_train = fused_train
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

    def fused_params(self):
        """This block's parameters in the JAX package's keys and
        layouts, as views of the module's own tensors (autograd carries
        the gradients back through the permutes)."""
        conv1 = self.conv1
        return {
            "dw_kernel": conv1.conv.weight.permute(2, 1, 0),  # (K, 1, C)
            "dw_bias": conv1.conv.bias,
            "bn0_scale": conv1.bn.weight, "bn0_bias": conv1.bn.bias,
            "pw1_kernel": conv1.pointwise.weight[:, :, 0].t(),  # (in, out)
            "pw1_bias": conv1.pointwise.bias,
            "bn1_scale": self.bn1.weight, "bn1_bias": self.bn1.bias,
            "pw2_kernel": self.conv2.weight[:, :, 0].t(),
            "pw2_bias": self.conv2.bias,
            "bn2_scale": self.bn2.weight, "bn2_bias": self.bn2.bias,
        }

    def _fused_forward(self, x: torch.Tensor) -> torch.Tensor:
        y, stats = fused_tcn_block_train(
            x, self.fused_params(), self.kernel_size, self.dilation,
            self.bn1.eps)
        for i, bn in enumerate((self.conv1.bn, self.bn1, self.bn2)):
            bn.update_running_stats(stats[f"mu{i}"], stats[f"var{i}"])
        return y

    def forward(
        self, x: torch.Tensor, cache: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if (self.fused_train and self.training and cache is None
                and self.in_channels == self.res_channels):
            return self._fused_forward(x), None
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
    def __init__(self, channels: int, stack_size: int, kernel_size: int,
                 fused_train: bool = False):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            TCNBlock(channels, channels, kernel_size, 2 ** i, fused_train)
            for i in range(stack_size)
        )


class MDTC(nn.Module):
    def __init__(self, stack_num: int, stack_size: int, in_channels: int,
                 res_channels: int, kernel_size: int, causal: bool = True,
                 fused_train: bool = False):
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
                                     1, fused_train)
        self.blocks = nn.ModuleList(
            TCNStack(res_channels, stack_size, kernel_size, fused_train)
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
