"""Whole-backbone fused MDTC forward: CUDA kernel and its plain version.

The JAX package runs the BN-folded MDTC backbone as one Pallas program
(wekws_tpu/ops/fused_mdtc.py); here the same function is the
hand-written Hopper kernel ``csrc/fused_mdtc.cu``, launched through
``ctypes``.  Layouts are the JAX package's: activations ``(B, T, C)``,
weight stacks ``(L, K, C)``, ``(L, C)`` and ``(L, C, C)`` (input
channels first), streaming cache ``(L, B, pad_max, C)``.

Layer math (BN folded):
    a = dw_conv(x_padded)            # (K, C) taps, dilation d, + bias
    b = relu(a @ W1 + b1)
    y = relu(b @ W2 + b2 + x)        # residual
Every ``stack_size``-th layer after the preprocessor adds its output
into the result (multi-scale aggregation).

``fused_mdtc_forward`` and ``fused_mdtc_stream`` take the plain
PyTorch version only for tensors on the CPU; for CUDA tensors they
launch the kernel or raise.  Each counts its kernel launches in its
``launches`` attribute.
"""

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from wekws_tpu_torch.ops import cuda_build
from wekws_tpu_torch.ops.fused_common import (
    check_tensor as _check,
    fold_bn,
    init_ring_cache,
)

init_stream_cache = init_ring_cache

KERNEL_CHANNELS = (32, 64, 128)
MAX_LAYERS = 64


def _pad_max(dilations: Sequence[int], kernel_size: int) -> int:
    return (kernel_size - 1) * max(dilations)


def _mdtc_plain(x, cache, dw_w, dw_b, pw1_w, pw1_b, pw2_w, pw2_b,
                dilations, kernel_size, stack_size):
    b, t, c = x.shape
    k = kernel_size
    pad_max = _pad_max(dilations, k)
    act = x
    acc = torch.zeros_like(x)
    new_cache = []
    for layer, dil in enumerate(dilations):
        left = cache[layer] if cache is not None else x.new_zeros(
            (b, pad_max, c))
        window = torch.cat([left, act], dim=1)  # (B, pad_max + T, C)
        if cache is not None:
            new_cache.append(window[:, t:t + pad_max])
        a = torch.zeros_like(act)
        for tap in range(k):
            off = pad_max - (k - 1 - tap) * dil
            a = a + window[:, off:off + t] * dw_w[layer, tap]
        a = a + dw_b[layer]
        h = torch.relu(torch.matmul(a, pw1_w[layer]) + pw1_b[layer])
        y = torch.relu(torch.matmul(h, pw2_w[layer]) + pw2_b[layer] + act)
        act = y
        if layer > 0 and layer % stack_size == 0:
            acc = acc + y
    return acc, (torch.stack(new_cache) if cache is not None else None)


def fused_mdtc_forward_plain(x, dw_w, dw_b, pw1_w, pw1_b, pw2_w, pw2_b,
                             dilations, kernel_size, stack_size):
    """Eager PyTorch version of the whole-utterance kernel."""
    out, _ = _mdtc_plain(x, None, dw_w, dw_b, pw1_w, pw1_b, pw2_w, pw2_b,
                         dilations, kernel_size, stack_size)
    return out


def fused_mdtc_stream_plain(x, cache, dw_w, dw_b, pw1_w, pw1_b, pw2_w,
                            pw2_b, dilations, kernel_size, stack_size):
    """Eager PyTorch version of the streaming kernel."""
    return _mdtc_plain(x, cache, dw_w, dw_b, pw1_w, pw1_b, pw2_w, pw2_b,
                       dilations, kernel_size, stack_size)


def _validate(x, cache, weights, dilations, kernel_size, stack_size):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    b, t, c = x.shape
    n_layers = len(dilations)
    if b < 1 or t < 1 or n_layers < 1 or stack_size < 1:
        raise ValueError("empty batch, chunk, layer list or stack")
    dev = x.device
    _check("x", x, (b, t, c), dev)
    k = kernel_size
    shapes = ((n_layers, k, c), (n_layers, c), (n_layers, c, c),
              (n_layers, c), (n_layers, c, c), (n_layers, c))
    names = ("dw_w", "dw_b", "pw1_w", "pw1_b", "pw2_w", "pw2_b")
    for name, w, shape in zip(names, weights, shapes):
        _check(name, w, shape, dev)
    if cache is not None:
        _check("cache", cache, (n_layers, b, _pad_max(dilations, k), c), dev)
    if dev.type == "cuda":
        if c not in KERNEL_CHANNELS:
            raise ValueError(f"the CUDA kernel takes C in {KERNEL_CHANNELS}, "
                             f"got {c}")
        if n_layers > MAX_LAYERS:
            raise ValueError(f"the CUDA kernel takes at most {MAX_LAYERS} "
                             f"layers, got {n_layers}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")


def _kernel_fn():
    lib = cuda_build.load("fused_mdtc")
    fn = lib.fused_mdtc_launch
    if fn.argtypes is None:  # without argtypes ctypes cuts pointers to int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_mdtc_error_string.argtypes = [ctypes.c_int]
        lib.fused_mdtc_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(x, cache, weights, dilations, kernel_size, stack_size):
    """One kernel launch on x's device and current stream."""
    lib, fn = _kernel_fn()
    b, t, c = x.shape
    n_layers = len(dilations)
    pad_max = _pad_max(dilations, kernel_size)
    out = torch.empty_like(x)
    # fresh output cache: the kernel reads cache_in[l] while writing
    # cache_out[l], so the two must never alias
    cache_out = torch.empty_like(cache) if cache is not None else None
    act = torch.empty((b, 2, pad_max + t, c), dtype=torch.float32,
                      device=x.device)
    dil = (ctypes.c_int * n_layers)(*[int(d) for d in dilations])
    ptr = [w.data_ptr() for w in weights]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(),
                 cache.data_ptr() if cache is not None else None,
                 *ptr, out.data_ptr(),
                 cache_out.data_ptr() if cache_out is not None else None,
                 act.data_ptr(), b, t, c, n_layers, kernel_size, stack_size,
                 pad_max, dil, stream)
    if err != 0:
        msg = lib.fused_mdtc_error_string(err).decode()
        raise RuntimeError(f"fused_mdtc kernel launch failed: {msg} ({err})")
    return out, cache_out


def fused_mdtc_forward(
    x: torch.Tensor,
    dw_w: torch.Tensor,
    dw_b: torch.Tensor,
    pw1_w: torch.Tensor,
    pw1_b: torch.Tensor,
    pw2_w: torch.Tensor,
    pw2_b: torch.Tensor,
    dilations: Tuple[int, ...],
    kernel_size: int,
    stack_size: int,
) -> torch.Tensor:
    """x: (B, T, C) float32; weight stacks (L, K, C), (L, C), (L, C, C)
    x2.  ``dilations`` lists every layer including the dilation-1
    preprocessor.  Zero left context.  Returns (B, T, C)."""
    weights = (dw_w, dw_b, pw1_w, pw1_b, pw2_w, pw2_b)
    _validate(x, None, weights, dilations, kernel_size, stack_size)
    if x.device.type == "cpu":
        return fused_mdtc_forward_plain(x, *weights, dilations, kernel_size,
                                        stack_size)
    out, _ = _launch(x, None, weights, dilations, kernel_size, stack_size)
    fused_mdtc_forward.launches += 1
    return out


def fused_mdtc_stream(
    x: torch.Tensor,
    cache: torch.Tensor,
    dw_w: torch.Tensor,
    dw_b: torch.Tensor,
    pw1_w: torch.Tensor,
    pw1_b: torch.Tensor,
    pw2_w: torch.Tensor,
    pw2_b: torch.Tensor,
    dilations: Tuple[int, ...],
    kernel_size: int,
    stack_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk with carried context.

    cache: (L, B, pad_max, C), per layer the last ``pad_max`` input
    frames that layer has seen (zeros at stream start).  Returns
    (y, new_cache); chunked calls equal ``fused_mdtc_forward`` on the
    concatenated input.  The new cache is a fresh tensor."""
    weights = (dw_w, dw_b, pw1_w, pw1_b, pw2_w, pw2_b)
    _validate(x, cache, weights, dilations, kernel_size, stack_size)
    if x.device.type == "cpu":
        return fused_mdtc_stream_plain(x, cache, *weights, dilations,
                                       kernel_size, stack_size)
    out, new_cache = _launch(x, cache, weights, dilations, kernel_size,
                             stack_size)
    fused_mdtc_stream.launches += 1
    return out, new_cache


fused_mdtc_forward.launches = 0
fused_mdtc_stream.launches = 0


def extract_mdtc_weights(mdtc):
    """Port MDTC module -> folded float32 CPU weight stacks.

    Returns (dw_w, dw_b, pw1_w, pw1_b, pw2_w, pw2_b, dilations).
    Requires in_channels == res_channels (init_model always builds MDTC
    that way)."""
    if mdtc.in_channels != mdtc.res_channels:
        raise ValueError("fused MDTC needs in_channels == res_channels")
    blocks = [mdtc.preprocessor] + [
        blk for stack in mdtc.blocks for blk in stack.res_blocks
    ]
    dilations = tuple(blk.dilation for blk in blocks)
    stacks = [[] for _ in range(6)]
    for blk in blocks:
        folds = (
            # depthwise (C, 1, K) -> (K, C), then the DS conv's BN
            (blk.conv1.conv.weight[:, 0, :].t(), blk.conv1.conv.bias,
             blk.conv1.bn),
            # pointwise (out, in, 1) -> (in, out), then bn1
            (blk.conv1.pointwise.weight[:, :, 0].t(),
             blk.conv1.pointwise.bias, blk.bn1),
            (blk.conv2.weight[:, :, 0].t(), blk.conv2.bias, blk.bn2),
        )
        for i, (w, bias, bn) in enumerate(folds):
            fw, fb = fold_bn(w, bias, bn.weight, bn.bias, bn.running_mean,
                             bn.running_var, bn.eps)
            stacks[2 * i].append(fw)
            stacks[2 * i + 1].append(fb)
    return tuple(torch.stack(s).contiguous() for s in stacks) + (dilations,)
