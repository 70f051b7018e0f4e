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
of a block whose input and output widths match (and without
``ghost_bn``, as in the JAX package) runs through
``ops/fused_mdtc_train.fused_tcn_block_train`` (the eight fused
exact-BN passes, at ``precision="bfloat16"`` when ``dtype`` is bf16)
and updates the three BatchNorms' running statistics from the batch
statistics it returns; everything else runs the plain modules, whose
BatchNorms train with the same exact-BN semantics.

The JAX package's training knobs: ``dtype`` is the convolutions' compute
dtype (``layers.py``), ``bn_dtype`` the BatchNorms' output dtype,
``ghost_bn`` their per-group statistics (``layers.GhostBatchNorm``),
and residuals add ``x`` in the block output's dtype; ``MDTC`` returns
float32 (float64 stays float64).  The fused block ignores ``bn_dtype``
and gives y in x's dtype, as JAX's does.  ``remat`` recomputes each
block in the backward (``torch.utils.checkpoint``, non-reentrant, on
both routes): the checkpointed function returns the block's output and
its batch statistics, and the running averages (and
``num_batches_tracked``) are updated once, outside it, so that the
recomputation cannot update them twice.
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from wekws_tpu_torch.models.layers import (
    DepthwiseConv1d,
    PointwiseConv1d,
    batch_norm,
    float_out,
)
from wekws_tpu_torch.ops.fused_mdtc_train import fused_tcn_block_train


class DSDilatedConv1d(nn.Module):
    """Dilated depthwise-separable conv: DW conv -> BN -> pointwise
    (``TCNBlock._body`` runs the three, so that a remat block can take
    the BN's statistics)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, dilation: int = 1,
                 dtype: Optional[torch.dtype] = None, ghost_bn: int = 0,
                 bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = DepthwiseConv1d(in_channels, kernel_size, dilation,
                                    dtype=dtype)
        self.bn = batch_norm(in_channels, ghost_bn, bn_dtype)
        self.pointwise = PointwiseConv1d(in_channels, out_channels,
                                         dtype=dtype)


class TCNBlock(nn.Module):
    def __init__(self, in_channels: int, res_channels: int,
                 kernel_size: int, dilation: int, fused_train: bool = False,
                 dtype: Optional[torch.dtype] = None, ghost_bn: int = 0,
                 bn_dtype: Optional[torch.dtype] = None,
                 remat: bool = False):
        super().__init__()
        self.fused_train = fused_train
        self.in_channels = in_channels
        self.res_channels = res_channels
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.dtype = dtype
        self.ghost_bn = ghost_bn
        self.remat = remat
        self.conv1 = DSDilatedConv1d(in_channels, res_channels, kernel_size,
                                     dilation, dtype, ghost_bn, bn_dtype)
        self.bn1 = batch_norm(res_channels, ghost_bn, bn_dtype)
        self.conv2 = PointwiseConv1d(res_channels, res_channels, dtype=dtype)
        self.bn2 = batch_norm(res_channels, ghost_bn, bn_dtype)

    @property
    def padding(self) -> int:
        return (self.kernel_size - 1) * self.dilation

    @property
    def precision(self) -> str:
        """The fused passes' precision: bf16 operands where the block
        computes in bf16, as the JAX package picks it."""
        return "bfloat16" if self.dtype == torch.bfloat16 else "float32"

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

    def _bns(self):
        return (self.conv1.bn, self.bn1, self.bn2)

    def _fused(self, cache) -> bool:
        return (self.fused_train and self.training and cache is None
                and self.in_channels == self.res_channels
                and not self.ghost_bn)

    def _body(self, x: torch.Tensor, cache: Optional[torch.Tensor],
              stats: Optional[list]):
        """(y, new cache).  With ``stats`` a list, each training BN's
        (mean, var) is appended to it and no running statistic is
        touched; with None the BatchNorms update their own."""
        if self._fused(cache):
            y, st = fused_tcn_block_train(
                x.float(), self.fused_params(), self.kernel_size,
                self.dilation, self.bn1.eps, self.precision)
            pairs = [(st[f"mu{i}"], st[f"var{i}"]) for i in range(3)]
            if stats is None:
                for bn, (mean, var) in zip(self._bns(), pairs):
                    bn.update_running_stats(mean, var)
            else:
                stats.extend(t for pair in pairs for t in pair)
            return y.to(x.dtype), None

        def norm(bn, y):
            if stats is None or not bn.training:
                return bn(y)
            y, mean, var = bn.batch_forward(y)
            stats.extend((mean, var))
            return y

        conv1 = self.conv1
        if cache is None:
            y = conv1.conv(x, left_pad=self.padding)
            new_cache = None
        else:
            y = torch.cat([cache, x], dim=1)
            new_cache = y[:, y.shape[1] - self.padding:, :]
            y = conv1.conv(y)
        y = conv1.pointwise(norm(conv1.bn, y))
        y = torch.relu(norm(self.bn1, y))
        y = norm(self.bn2, self.conv2(y))
        if self.in_channels == self.res_channels:
            y = y + x.to(y.dtype)
        return torch.relu(y), new_cache

    def forward(
        self, x: torch.Tensor, cache: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if not (self.remat and self.training and cache is None
                and torch.is_grad_enabled()):
            return self._body(x, cache, None)

        def run(xx):
            stats = []
            y, _ = self._body(xx, None, stats)
            return (y, *stats)

        y, *stats = checkpoint(run, x, use_reentrant=False)
        for i, bn in enumerate(self._bns()):
            bn.update_running_stats(stats[2 * i], stats[2 * i + 1])
        return y, None


class TCNStack(nn.Module):
    def __init__(self, channels: int, stack_size: int, kernel_size: int,
                 fused_train: bool = False, **knobs):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            TCNBlock(channels, channels, kernel_size, 2 ** i, fused_train,
                     **knobs)
            for i in range(stack_size)
        )


class MDTC(nn.Module):
    def __init__(self, stack_num: int, stack_size: int, in_channels: int,
                 res_channels: int, kernel_size: int, causal: bool = True,
                 fused_train: bool = False,
                 dtype: Optional[torch.dtype] = None, remat: bool = False,
                 ghost_bn: int = 0, bn_dtype: Optional[torch.dtype] = None):
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
        knobs = dict(dtype=dtype, ghost_bn=ghost_bn, bn_dtype=bn_dtype,
                     remat=remat)
        self.preprocessor = TCNBlock(in_channels, res_channels, kernel_size,
                                     1, fused_train, **knobs)
        self.blocks = nn.ModuleList(
            TCNStack(res_channels, stack_size, kernel_size, fused_train,
                     **knobs)
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
        return float_out(outputs), tuple(new_caches)
