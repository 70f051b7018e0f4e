"""Multi-layer GRU backbone.

Port of wekws_tpu/models/gru.py, with the gate equations of
``torch.nn.GRU`` (gate order r, z, n), which are the JAX module's:

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

The parameters are ``nn.GRU``'s, by name and layout
(``weight_ih_l{k}`` (3H, D), ``bias_ih_l{k}``, ``weight_hh_l{k}``
(3H, H), ``bias_hh_l{k}``), so a reference state_dict loads as is.

The computation has the JAX module's shape: one (B*T, D) x (D, 3H)
input product per layer, then a loop over frames of the (B, H) x
(H, 3H) hidden product and the gates, all float32 products with
autograd.  The JAX package has no TPU kernel for it.  ``nn.GRU`` is not
called: on the card it runs cuDNN, whose float32 RNN products default
to TF32 in the forward and in the backward alike.  The recurrence runs
over padded frames too, as the JAX ``lax.scan`` does: no sequence
packing.

Cache (streaming state): the hidden state in the JAX package's layout
``(B, num_layers, H)`` (``nn.GRU``'s ``h_n`` transposed).
"""

from typing import Tuple

import torch
from torch import nn


class GRU(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int):
        super().__init__()
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        for k in range(num_layers):
            d = input_dim if k == 0 else hidden_dim
            for name, shape in ((f"weight_ih_l{k}", (3 * hidden_dim, d)),
                                (f"bias_ih_l{k}", (3 * hidden_dim,)),
                                (f"weight_hh_l{k}",
                                 (3 * hidden_dim, hidden_dim)),
                                (f"bias_hh_l{k}", (3 * hidden_dim,))):
                self.register_parameter(name,
                                        nn.Parameter(torch.zeros(shape)))

    @property
    def padding(self) -> int:
        return 0

    def init_cache(self, batch_size: int, device="cpu"):
        return torch.zeros((batch_size, self.num_layers, self.hidden_dim),
                           dtype=torch.float32, device=device)

    def layer_weights(self, k: int):
        """(W_ih (3H, D), b_ih, W_hh (3H, H), b_hh) of layer ``k``."""
        return tuple(getattr(self, f"{w}_l{k}") for w in
                     ("weight_ih", "bias_ih", "weight_hh", "bias_hh"))

    def _layer(self, k: int, x: torch.Tensor,
               h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        w_ih, b_ih, w_hh, b_hh = self.layer_weights(k)
        hid = self.hidden_dim
        x_proj = nn.functional.linear(x, w_ih, b_ih)  # (B, T, 3H)
        w_hh_t = w_hh.t()
        ys = []
        for t in range(x.shape[1]):
            xp = x_proj[:, t]
            h_proj = torch.addmm(b_hh, h, w_hh_t)
            rz = torch.sigmoid(xp[:, :2 * hid] + h_proj[:, :2 * hid])
            r, z = rz[:, :hid], rz[:, hid:]
            n = torch.tanh(xp[:, 2 * hid:] + r * h_proj[:, 2 * hid:])
            h = (1.0 - z) * n + z * h
            ys.append(h)
        if not ys:
            return x_proj[..., :hid], h
        return torch.stack(ys, dim=1), h

    def forward(self, x: torch.Tensor,
                cache=None) -> Tuple[torch.Tensor, torch.Tensor]:
        if cache is None:
            cache = self.init_cache(x.shape[0], x.device)
        cache = cache.to(x.dtype)
        h_out = []
        for k in range(self.num_layers):
            x, h_last = self._layer(k, x, cache[:, k, :])
            h_out.append(h_last)
        return x, torch.stack(h_out, dim=1)
