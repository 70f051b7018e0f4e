"""Feed-forward Sequential Memory Network (FSMN) backbone.

Port of wekws_tpu/models/fsmn.py with the reference wekws module names
(``in_linear1.linear``, ``fsmn.{i}.{0,2}.linear``,
``fsmn.{i}.1.conv_{left,right}``, ``out_linear{1,2}.linear``).  Each
layer is LinearTransform (no bias) -> FSMNBlock -> AffineTransform ->
ReLU; the network is in_linear1 -> in_linear2 -> ReLU -> N layers ->
out_linear1 -> out_linear2.

``FSMNBlock`` adds depthwise memory taps over left (``lorder`` taps at
stride ``lstride``, the current frame included) and right (``rorder``
look-ahead taps at stride ``rstride``) context to the identity path.
A nonzero ``rorder`` delays the output: output frame t belongs to input
frame ``t - rorder * rstride``, which is what lets the block stream
with a purely left-sided cache.

Cache: per layer ``(B, P, proj_dim)`` with
``P = (lorder - 1) * lstride + rorder * rstride``, zeros at start, as
a tuple.  The taps are shifted multiply-adds over the ``[cache, x]``
window (``layers.MemoryTaps``), not a grouped ``conv1d``, which cuDNN
would run in TF32.

``dtype`` (the JAX package's compute dtype) reaches every dense layer
and the memory taps (``layers.linear``, ``layers.MemoryTaps``); the
identity path adds the block's input in the taps' dtype, and ``FSMN``
returns float32.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from wekws_tpu_torch.models.layers import MemoryTaps, float_out, linear


class LinearTransform(nn.Module):
    def __init__(self, input_dim: int, output_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(input_dim, output_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.linear.weight, None, self.dtype)


class AffineTransform(nn.Module):
    def __init__(self, input_dim: int, output_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.linear = nn.Linear(input_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.linear.weight, self.linear.bias, self.dtype)


class FSMNBlock(nn.Module):
    def __init__(self, dim: int, lorder: int, rorder: int, lstride: int = 1,
                 rstride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim = dim
        self.lorder = lorder
        self.rorder = rorder
        self.lstride = lstride
        self.rstride = rstride
        self.conv_left = MemoryTaps(dim, lorder, lstride, dtype)
        self.conv_right = (MemoryTaps(dim, rorder, rstride, dtype)
                           if rorder > 0 else None)

    @property
    def padding(self) -> int:
        return (self.lorder - 1) * self.lstride + self.rorder * self.rstride

    def forward(self, x: torch.Tensor,
                cache: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        t = x.shape[1]
        # (B, P + T, D), in the wider of the two dtypes, as JAX's
        # concatenate promotes
        wide = torch.promote_types(cache.dtype, x.dtype)
        y = torch.cat([cache.to(wide), x.to(wide)], dim=1)
        new_cache = y[:, y.shape[1] - self.padding:, :]
        rspan = self.rorder * self.rstride
        # identity path: input frames aligned with the delayed output
        start = (self.lorder - 1) * self.lstride
        left = self.conv_left(y[:, :y.shape[1] - rspan, :])
        out = y[:, start:start + t, :].to(left.dtype) + left
        if self.conv_right is not None:
            # look-ahead taps start one rstride past the current frame
            out = out + self.conv_right(y[:, start + self.rstride:, :])
        return out, new_cache


class FSMN(nn.Module):
    def __init__(self, input_dim: int, input_affine_dim: int,
                 fsmn_layers: int, linear_dim: int, proj_dim: int,
                 lorder: int, rorder: int, lstride: int, rstride: int,
                 output_affine_dim: int, output_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fsmn_layers = fsmn_layers
        self.linear_dim = linear_dim
        self.proj_dim = proj_dim
        self.lorder = lorder
        self.rorder = rorder
        self.lstride = lstride
        self.rstride = rstride
        self.in_linear1 = AffineTransform(input_dim, input_affine_dim, dtype)
        self.in_linear2 = AffineTransform(input_affine_dim, linear_dim, dtype)
        self.fsmn = nn.ModuleList(
            nn.Sequential(
                LinearTransform(linear_dim, proj_dim, dtype),
                FSMNBlock(proj_dim, lorder, rorder, lstride, rstride, dtype),
                AffineTransform(proj_dim, linear_dim, dtype),
                nn.ReLU())
            for _ in range(fsmn_layers))
        self.out_linear1 = AffineTransform(linear_dim, output_affine_dim,
                                           dtype)
        self.out_linear2 = AffineTransform(output_affine_dim, output_dim,
                                           dtype)

    @property
    def layer_padding(self) -> int:
        return (self.lorder - 1) * self.lstride + self.rorder * self.rstride

    @property
    def padding(self) -> int:
        return self.layer_padding * self.fsmn_layers

    def init_cache(self, batch_size: int, device="cpu"):
        return tuple(
            torch.zeros((batch_size, self.layer_padding, self.proj_dim),
                        dtype=torch.float32, device=device)
            for _ in range(self.fsmn_layers))

    def forward(self, x: torch.Tensor, cache=None):
        if cache is None:
            cache = self.init_cache(x.shape[0], x.device)
            cache = tuple(c.to(x.dtype) for c in cache)
        x = torch.relu(self.in_linear2(self.in_linear1(x)))
        new_caches = []
        for (proj, block, affine, relu), c in zip(self.fsmn, cache):
            x, c = block(proj(x), c)
            new_caches.append(c)
            x = relu(affine(x))
        return (float_out(self.out_linear2(self.out_linear1(x))),
                tuple(new_caches))
