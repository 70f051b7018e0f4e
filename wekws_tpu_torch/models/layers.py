"""Layers shared by the backbones, feature-last ``(B, T, C)``.

Parameter names and shapes follow the reference wekws ``nn.Conv1d`` /
``nn.BatchNorm1d`` modules, so a reference state_dict loads as is:
depthwise ``weight (C, 1, K)``, pointwise ``weight (out, in, 1)``,
BatchNorm ``weight, bias, running_mean, running_var,
num_batches_tracked``.

The depthwise conv is K shifted multiply-adds (a cross-correlation
with taps at ``t + j*d``, the reference's ``groups=C`` conv).  Its
gradient is plain autograd: the JAX package's custom depthwise VJP
(wekws_tpu/models/layers.py:134-198) only steers XLA's fusion and
equals autodiff.  ``BatchNorm`` trains with the semantics of the JAX
package's ``ExactBatchNorm``; its hand-written VJP there is autodiff
too, so plain autograd gives the same gradients.
"""

import torch
from torch import nn

from wekws_tpu_torch.parallel.mesh import all_reduce_sum_grad, is_distributed


class DepthwiseConv1d(nn.Module):
    """Causal dilated depthwise conv, VALID after ``left_pad`` zeros.

    Input ``(B, T_in, C)`` -> ``(B, T_in + left_pad - (K-1)*d, C)``.
    A streaming caller passes ``left_pad=0`` and prepends its cache."""

    def __init__(self, channels: int, kernel_size: int, dilation: int = 1,
                 bias: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels)) if bias else None

    def forward(self, x: torch.Tensor, left_pad: int = 0) -> torch.Tensor:
        if left_pad:
            x = nn.functional.pad(x, (0, 0, left_pad, 0))
        k, d = self.kernel_size, self.dilation
        t_out = x.shape[1] - (k - 1) * d
        w = self.weight[:, 0, :]  # (C, K)
        y = None
        for j in range(k):
            tap = x[:, j * d:j * d + t_out, :] * w[:, j]
            y = tap if y is None else y + tap
        if self.bias is not None:
            y = y + self.bias
        return y


class Conv1d(nn.Module):
    """Causal dilated full convolution, VALID after ``left_pad`` zeros,
    stored as the reference ``Conv1d`` (``weight (out, in, K)``).

    K shifted float32 matmuls rather than ``F.conv1d``: cuDNN runs a
    float32 convolution in TF32 by default, a plain matmul does not."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, left_pad: int = 0) -> torch.Tensor:
        if left_pad:
            x = nn.functional.pad(x, (0, 0, left_pad, 0))
        k, d = self.kernel_size, self.dilation
        t_out = x.shape[1] - (k - 1) * d
        y = self.bias
        for j in range(k):
            y = y + torch.matmul(x[:, j * d:j * d + t_out, :],
                                 self.weight[:, :, j].t())
        return y


class MemoryTaps(nn.Module):
    """Depthwise FSMN memory taps without bias, stored as the
    reference's ``Conv2d`` weight ``(C, 1, order, 1)``.  ``forward``
    is a VALID cross-correlation over time as shifted multiply-adds:
    ``(B, T_in, C) -> (B, T_in - (order-1)*stride, C)``."""

    def __init__(self, channels: int, order: int, stride: int = 1):
        super().__init__()
        self.order = order
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(channels, 1, order, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t_out = x.shape[1] - (self.order - 1) * self.stride
        w = self.weight[:, 0, :, 0]  # (C, order)
        y = None
        for j in range(self.order):
            s = j * self.stride
            tap = x[:, s:s + t_out, :] * w[:, j]
            y = tap if y is None else y + tap
        return y


class PointwiseConv1d(nn.Module):
    """1x1 conv over channels, stored as the reference ``Conv1d``."""

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.weight[:, :, 0], self.bias)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis.

    Eval: running statistics.  Training (``ExactBatchNorm`` of the JAX
    package): batch mean and variance ``E[x^2] - E[x]^2`` in float32
    (float64 input stays float64) over every axis but the last, and
    running averages with flax's
    momentum 0.9 (torch ``momentum=0.1``) that take the BIASED batch
    variance, unlike ``nn.BatchNorm1d``.

    Under data parallelism (a process group initialised) the batch is
    the global one, as in the JAX package's mesh: the sums of x and x^2
    and the count go through one differentiable all-reduce (autograd
    carries the statistics' gradient to every rank's rows), so the
    statistics and the running averages are the same on every rank."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x - self.running_mean) * inv + self.bias
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(x.dim() - 1))
        if is_distributed():
            c = x32.shape[-1]
            count = x32.new_full((1, c), x32.numel() // c)
            sums = all_reduce_sum_grad(torch.cat([
                x32.sum(dim=axes)[None], (x32 * x32).sum(dim=axes)[None],
                count]))
            mean = sums[0] / sums[2]
            var = sums[1] / sums[2] - mean * mean
        else:
            mean = x32.mean(dim=axes)
            var = (x32 * x32).mean(dim=axes) - mean * mean
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias
        self.update_running_stats(mean, var)
        return y

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor,
                             var: torch.Tensor) -> None:
        """ra = (1 - momentum) * ra + momentum * batch statistic."""
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
        self.running_var.mul_(1.0 - m).add_(m * var.detach())
        self.num_batches_tracked.add_(1)
