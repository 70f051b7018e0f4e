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

Mixed precision (the model config's ``dtype``, the JAX package's
compute dtype): the convolutions and ``PointwiseConv1d`` take a
``dtype``, cast their input and weight to it and give their output in
it, with float32 parameters whose gradients come back float32 through
the cast, as flax's ``dtype=`` does.  The depthwise taps (and the full
``Conv1d``, and ``MemoryTaps``) are formed in float32 on the rounded
operands and rounded once, where XLA's grouped or full convolution
rounds its sum once; K shifted multiply-adds in bf16 would round at
every tap.  A bias is added after the rounding, in the compute dtype,
as flax adds it (two roundings); ``F.linear`` with a bias would fuse it
before one.  No ``autocast``: its op lists are not flax's cast points.
``BatchNorm`` computes its statistics in float32 always and gives
float32 output unless ``out_dtype`` (the JAX package's ``bn_dtype``)
narrows it; ``GhostBatchNorm`` is the JAX package's per-group variant,
``batch_norm`` the factory that picks one.
"""

from typing import Optional

import torch
from torch import nn

from wekws_tpu_torch.parallel.mesh import (
    all_reduce_sum_grad,
    gather_counts,
    is_distributed,
    process_index,
)


def _rounded(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``t`` as an operand in ``dtype``: rounded to it, and widened to
    float32 for a float32 sum (exact in its products).  Gradients pass
    back through both casts, rounded to ``dtype`` once, as the gradient
    of XLA's ``dtype`` convolution is."""
    return t.to(dtype).to(torch.float32)


def float_out(y: torch.Tensor) -> torch.Tensor:
    """A backbone's output: float32 (or wider), as JAX's
    ``.astype(jnp.float32)``, a float64 model's kept float64."""
    return y.to(torch.promote_types(y.dtype, torch.float32))


def _taps(x: torch.Tensor, w: torch.Tensor, step: int,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``y[t] = sum_j x[t + j*step] * w[:, j]`` over the (C, K) taps
    ``w``: in x's dtype without ``dtype``, else in float32 on operands
    rounded to ``dtype`` and rounded once."""
    if dtype is not None:
        x, w = _rounded(x, dtype), _rounded(w, dtype)
    t_out = x.shape[1] - (w.shape[1] - 1) * step
    y = None
    for j in range(w.shape[1]):
        tap = x[:, j * step:j * step + t_out, :] * w[:, j]
        y = tap if y is None else y + tap
    return y if dtype is None else y.to(dtype)


class DepthwiseConv1d(nn.Module):
    """Causal dilated depthwise conv, VALID after ``left_pad`` zeros.

    Input ``(B, T_in, C)`` -> ``(B, T_in + left_pad - (K-1)*d, C)``.
    A streaming caller passes ``left_pad=0`` and prepends its cache.
    ``dtype``: the compute dtype (output in it; module docstring)."""

    def __init__(self, channels: int, kernel_size: int, dilation: int = 1,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels)) if bias else None

    def forward(self, x: torch.Tensor, left_pad: int = 0) -> torch.Tensor:
        if left_pad:
            x = nn.functional.pad(x, (0, 0, left_pad, 0))
        y = _taps(x, self.weight[:, 0, :], self.dilation, self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Conv1d(nn.Module):
    """Causal dilated full convolution, VALID after ``left_pad`` zeros,
    stored as the reference ``Conv1d`` (``weight (out, in, K)``).

    K shifted float32 matmuls rather than ``F.conv1d``: cuDNN runs a
    float32 convolution in TF32 by default, a plain matmul does not.
    With ``dtype`` the operands are rounded to it, the K products summed
    in float32 and rounded once, and the bias added in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, left_pad: int = 0) -> torch.Tensor:
        if left_pad:
            x = nn.functional.pad(x, (0, 0, left_pad, 0))
        k, d = self.kernel_size, self.dilation
        t_out = x.shape[1] - (k - 1) * d
        if self.dtype is None:
            x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
            y = self.bias
            for j in range(k):
                y = y + torch.matmul(x[:, j * d:j * d + t_out, :],
                                     self.weight[:, :, j].t())
            return y
        xr, wr = _rounded(x, self.dtype), _rounded(self.weight, self.dtype)
        y = None
        for j in range(k):
            tap = torch.matmul(xr[:, j * d:j * d + t_out, :], wr[:, :, j].t())
            y = tap if y is None else y + tap
        return y.to(self.dtype) + self.bias.to(self.dtype)


class MemoryTaps(nn.Module):
    """Depthwise FSMN memory taps without bias, stored as the
    reference's ``Conv2d`` weight ``(C, 1, order, 1)``.  ``forward``
    is a VALID cross-correlation over time as shifted multiply-adds:
    ``(B, T_in, C) -> (B, T_in - (order-1)*stride, C)``, in ``dtype``
    as ``DepthwiseConv1d``."""

    def __init__(self, channels: int, order: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.order = order
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(channels, 1, order, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _taps(x, self.weight[:, 0, :, 0], self.stride, self.dtype)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor],
           dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x @ weight.T + bias``; with ``dtype``, flax's ``Dense(dtype=)``:
    operands cast to ``dtype`` (one rounding of the float32-summed
    product), then the bias added in ``dtype``."""
    if dtype is None:  # promoted, as flax does without a dtype
        return nn.functional.linear(
            x.to(torch.promote_types(x.dtype, weight.dtype)), weight, bias)
    y = nn.functional.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


class PointwiseConv1d(nn.Module):
    """1x1 conv over channels, stored as the reference ``Conv1d``;
    ``dtype`` as ``linear``'s."""

    def __init__(self, in_channels: int, out_channels: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight[:, :, 0], self.bias, self.dtype)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis.

    Eval: running statistics.  Training (``ExactBatchNorm`` of the JAX
    package): batch mean and variance ``E[x^2] - E[x]^2`` in float32
    (float64 input stays float64) over every axis but the last, and
    running averages with flax's
    momentum 0.9 (torch ``momentum=0.1``) that take the BIASED batch
    variance, unlike ``nn.BatchNorm1d``.  The output is float32 (x's
    type promoted with float32) unless ``out_dtype`` (the JAX package's
    ``bn_dtype``) narrows it; the statistics are float32 either way.

    Under data parallelism (a process group initialised) the batch is
    the global one, as in the JAX package's mesh: the sums of x and x^2
    and the count go through one differentiable all-reduce (autograd
    carries the statistics' gradient to every rank's rows), so the
    statistics and the running averages are the same on every rank."""

    def __init__(self, num_features: int,
                 out_dtype: Optional[torch.dtype] = None):
        super().__init__(num_features)
        self.out_dtype = out_dtype

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.out_dtype is None else y.to(self.out_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            return self._out((x - self.running_mean) * inv + self.bias)
        y, mean, var = self.batch_forward(x)
        self.update_running_stats(mean, var)
        return y

    def batch_forward(self, x: torch.Tensor):
        """Training mode: ``(y, mean, var)`` of this batch, the running
        statistics untouched (``forward`` applies them; a block under
        ``remat`` applies them once, outside its recomputation)."""
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
        return self._out(y), mean, var

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor,
                             var: torch.Tensor) -> None:
        """ra = (1 - momentum) * ra + momentum * batch statistic."""
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
        self.running_var.mul_(1.0 - m).add_(m * var.detach())
        self.num_batches_tracked.add_(1)


def global_rows(b: int):
    """(this rank's first row in the global batch, the global batch's
    rows): the ranks' rows follow each other in rank order, as a JAX
    array sharded over the mesh's data axis lays them out.  (0, b)
    without a process group."""
    if not is_distributed():
        return 0, b
    rows = gather_counts(b)
    return sum(rows[:process_index()]), sum(rows)


class GhostBatchNorm(BatchNorm):
    """BatchNorm with per-group ("ghost") training statistics: the JAX
    package's ``GhostBatchNorm``, with ``BatchNorm``'s parameter and
    buffer names.

    Training: the batch's rows are cut into ``num_groups`` contiguous
    blocks (one group when the global batch does not divide, as JAX's
    ``g = G if b % G == 0 else 1``), each normalized by its own (group,
    channel) mean and two-pass variance (the mean of the squared
    deviations) in float32; the running statistics take the
    group-averaged moments.  The output keeps x's dtype (``out_dtype``,
    where set, is applied to x first), and the scale and bias are
    applied in it, as JAX's are.  Eval: the running statistics, in x's
    dtype.

    Under data parallelism the groups are the GLOBAL batch's row
    blocks, as in JAX's sharded array: a rank holds rows [r0, r0 + b),
    sums its rows into a (G, C) buffer (zero for groups it does not
    touch) with the groups' frame counts, and all-reduces both through
    ``all_reduce_sum_grad``, once for the means and once for the squared
    deviations."""

    def __init__(self, num_features: int, num_groups: int,
                 out_dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, out_dtype)
        self.num_groups = num_groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        if self.out_dtype is not None:
            x = x.to(self.out_dtype)
        dt = x.dtype
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean.to(dt)) * inv.to(dt)
                + self.bias.to(dt))

    def batch_forward(self, x: torch.Tensor):
        if self.out_dtype is not None:
            x = x.to(self.out_dtype)
        b, c = x.shape[0], x.shape[-1]
        r0, total = global_rows(b)
        g = self.num_groups if total % self.num_groups == 0 else 1
        gid = torch.div(torch.arange(r0, r0 + b, device=x.device),
                        total // g, rounding_mode="floor")
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(1, x.dim() - 1))  # a row's frames
        lead = (b,) + (1,) * len(axes) + (c,)

        def group_sums(rows):  # (b, C) -> (g, C), over every rank
            out = rows.new_zeros((g, c)).index_add(0, gid, rows)
            return all_reduce_sum_grad(out) if is_distributed() else out

        frames = x32.new_full((b, c), float(x32[0].numel() // c))
        sums, count = group_sums(x32.sum(dim=axes)), group_sums(frames)
        gmean = sums / count
        dev = x32 - gmean[gid].view(lead)
        gvar = group_sums((dev * dev).sum(dim=axes)) / count
        y = (dev * torch.rsqrt(gvar + self.eps)[gid].view(lead)).to(x.dtype)
        y = y * self.weight.to(x.dtype) + self.bias.to(x.dtype)
        return y, gmean.mean(dim=0), gvar.mean(dim=0)


def batch_norm(channels: int, ghost_bn: int = 0,
               out_dtype: Optional[torch.dtype] = None) -> BatchNorm:
    """The backbones' BN factory, the JAX package's ``batch_norm``:
    ``GhostBatchNorm`` where ``ghost_bn`` > 1, else ``BatchNorm``
    (exact global-batch statistics); ``out_dtype`` is the JAX package's
    ``bn_dtype``."""
    if ghost_bn and ghost_bn > 1:
        return GhostBatchNorm(channels, ghost_bn, out_dtype)
    return BatchNorm(channels, out_dtype)
