"""Whole-backbone fused DS-TCN forward: CUDA kernel and its plain version.

The JAX package runs the BN-folded depthwise-separable TCN as one
Pallas program (wekws_tpu/ops/fused_tcn.py); here the same function is
the hand-written Hopper kernel ``fused_ds_tcn_kernel`` of
``csrc/fused_mdtc.cu``: the MDTC serving kernel's body with the DS-TCN
layer, launched through ``ctypes`` on the plan of
``fused_mdtc.mdtc_plan(..., arch="ds_tcn")`` (a thread-block cluster per
batch row, the frames split over its blocks).  Layouts are the JAX
package's: activations ``(B, T, C)``, weight stacks ``(L, K, C)``,
``(L, C)``, ``(L, C, C)`` (input channels first) and ``(L, C)``,
streaming cache ``(L, B, pad_max, C)``.

Layer math (BN folded):
    a = dw_conv(x_padded) + b_dw      # (K, C) taps, dilation d_l
    h = relu(a)
    p = h @ W_pw + b_pw
    y = relu(p) + x                   # residual AFTER the relu
The output is the last layer's; ``new_cache[l]`` holds the last
``pad_max`` rows of ``[cache[l]; layer-l input]`` (only the last
``(K-1) * d_l`` are read, all are carried).

``fused_ds_tcn`` takes the plain PyTorch version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.  It counts
its kernel launches in ``fused_ds_tcn.launches``.  The JAX function's
``block_batch`` (a TPU tiling knob) has no counterpart.
"""

import ctypes
from typing import Sequence, Tuple

import torch

from wekws_tpu_torch.ops import fused_mdtc
from wekws_tpu_torch.ops.fused_common import (
    check_tensor,
    fold_bn,
    init_ring_cache,
)

init_tcn_cache = init_ring_cache

# the widths of the repo's DS-TCN recipes (hey_snips 64, synthetic 48,
# hi_xiaowen 256) and MDTC's
KERNEL_CHANNELS = (32, 48, 64, 128, 256)
MAX_LAYERS = 64
MAX_TAPS = 8


def _pad_max(dilations: Sequence[int], kernel_size: int) -> int:
    return (kernel_size - 1) * max(dilations)


def fused_ds_tcn_plain(x, cache, dw_w, dw_b, pw_w, pw_b, dilations,
                       kernel_size):
    """Eager PyTorch version of the kernel."""
    t = x.shape[1]
    k = kernel_size
    pad_max = _pad_max(dilations, k)
    act = x
    new_cache = []
    for layer, dil in enumerate(dilations):
        window = torch.cat([cache[layer], act], dim=1)  # (B, pad_max+T, C)
        new_cache.append(window[:, t:t + pad_max])
        a = torch.zeros_like(act)
        for tap in range(k):
            off = pad_max - (k - 1 - tap) * dil
            a = a + window[:, off:off + t] * dw_w[layer, tap]
        h = torch.relu(a + dw_b[layer])
        p = torch.matmul(h, pw_w[layer]) + pw_b[layer]
        act = torch.relu(p) + act
    return act, torch.stack(new_cache)


def _validate(x, cache, weights, dilations, kernel_size):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    b, t, c = x.shape
    n_layers = len(dilations)
    if b < 1 or t < 1 or n_layers < 1 or kernel_size < 1:
        raise ValueError("empty batch, chunk, layer list or kernel")
    dev = x.device
    check_tensor("x", x, (b, t, c), dev)
    k = kernel_size
    shapes = ((n_layers, k, c), (n_layers, c), (n_layers, c, c),
              (n_layers, c))
    for name, w, shape in zip(("dw_w", "dw_b", "pw_w", "pw_b"), weights,
                              shapes):
        check_tensor(name, w, shape, dev)
    check_tensor("cache", cache,
                 (n_layers, b, _pad_max(dilations, k), c), dev)
    if dev.type == "cuda":
        if c not in KERNEL_CHANNELS:
            raise ValueError(f"the CUDA kernel takes C in {KERNEL_CHANNELS}, "
                             f"got {c}")
        if n_layers > MAX_LAYERS or k > MAX_TAPS:
            raise ValueError(
                f"the CUDA kernel takes at most {MAX_LAYERS} layers and "
                f"{MAX_TAPS} taps, got {n_layers} and {k}")
        fused_mdtc.mdtc_plan(b, t, c, k, _pad_max(dilations, k),
                             arch="ds_tcn")
        if any(w.data_ptr() % 16 for w in (x, cache) + tuple(weights)):
            raise ValueError("the CUDA kernel's bulk copies need every "
                             "tensor 16-byte aligned")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")


def _launch(x, cache, weights, dilations, kernel_size, plan):
    """One kernel launch under ``plan`` on x's device and current
    stream."""
    lib = fused_mdtc.kernel_lib()
    b, t, c = x.shape
    n_layers = len(dilations)
    pad_max = _pad_max(dilations, kernel_size)
    out = torch.empty_like(x)
    # fresh output cache: the kernel reads cache[l] while writing
    # cache_out[l] (they overlap when T < pad_max), so they never alias
    cache_out = torch.empty_like(cache)
    # the layer outputs of a plan whose frames do not fit shared memory
    act = (None if plan["window"] == "smem" else
           torch.empty((b, 2, t, c), dtype=torch.float32, device=x.device))
    dil = (ctypes.c_int * n_layers)(*[int(d) for d in dilations])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_ds_tcn_launch(
            x.data_ptr(), cache.data_ptr(), *[w.data_ptr() for w in weights],
            out.data_ptr(), cache_out.data_ptr(),
            act.data_ptr() if act is not None else None, b, t, c, n_layers,
            kernel_size, pad_max, dil, *fused_mdtc.plan_args(plan), stream)
    fused_mdtc.raise_on_error(lib, err, "fused_ds_tcn")
    return out, cache_out


def fused_ds_tcn(
    x: torch.Tensor,
    cache: torch.Tensor,
    dw_w: torch.Tensor,
    dw_b: torch.Tensor,
    pw_w: torch.Tensor,
    pw_b: torch.Tensor,
    dilations: Tuple[int, ...],
    kernel_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, C) float32; cache: (L, B, pad_max, C) (zeros at
    start).  Returns (y (B, T, C), new_cache); chunked calls equal one
    whole-utterance call.  The new cache is a fresh tensor.  On CUDA:
    C in KERNEL_CHANNELS, at most 8 taps and 64 layers."""
    weights = (dw_w, dw_b, pw_w, pw_b)
    _validate(x, cache, weights, dilations, kernel_size)
    if x.device.type == "cpu":
        return fused_ds_tcn_plain(x, cache, *weights, dilations, kernel_size)
    plan = fused_mdtc.card_plan(*x.shape, kernel_size,
                                _pad_max(dilations, kernel_size), "ds_tcn")
    out = _launch(x, cache, weights, dilations, kernel_size, plan)
    fused_ds_tcn.launches += 1
    return out


fused_ds_tcn.launches = 0


def extract_ds_tcn_weights(tcn):
    """Port DS-TCN module -> folded float32 CPU weight stacks.

    Returns (dw_w, dw_b, pw_w, pw_b, dilations).  Only the ds variant
    fuses: the full-conv block's (K, C, C) kernels are K matmuls per
    layer, which stay on the module path."""
    if not tcn.ds:
        raise ValueError("the fused path covers the ds variant")
    stacks = [[] for _ in range(4)]
    for blk in tcn.network:
        dw, dw_bn, _, pw, pw_bn = blk.cnn[:5]
        folds = (
            # depthwise (C, 1, K) -> (K, C); pointwise (out, in, 1) ->
            # (in, out)
            (dw.weight[:, 0, :].t(), dw.bias, dw_bn),
            (pw.weight[:, :, 0].t(), pw.bias, pw_bn),
        )
        for i, (w, bias, bn) in enumerate(folds):
            fw, fb = fold_bn(w, bias, bn.weight, bn.bias, bn.running_mean,
                             bn.running_var, bn.eps)
            stacks[2 * i].append(fw)
            stacks[2 * i + 1].append(fb)
    dilations = tuple(blk.dilation for blk in tcn.network)
    return tuple(torch.stack(s).contiguous() for s in stacks) + (dilations,)
