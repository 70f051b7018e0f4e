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

The kernel runs one thread-block cluster per batch row, its blocks
splitting the frames; ``mdtc_plan`` chooses the cluster, the sub-tile,
where the layer inputs live (``WINDOWS``) and how many weight buffers a
block keeps from the shapes before the launch (``mdtc_smem_bytes``
mirrors the kernel's shared memory).  The wrapper raises when no
cluster of the plan's size can be resident on the card.
"""

import ctypes
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

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
THREADS = 256
SMEM_LIMIT = 232448  # bytes of shared memory a block may take (sm_90)
SMS = 132  # an H100 SXM's streaming multiprocessors
# the plan's rule: at most MAX_CLUSTER blocks a row (the portable
# cluster size) and at least MIN_ROWS frames a block
MAX_CLUSTER = 8
MIN_ROWS = 16
# shared memory a spread block asks for at least: more than half an SM's
# 228 KB, so that no two blocks share an SM
SPREAD_SMEM = 119808
# where a layer's input lies, in the plan's order of preference (the
# kernel's Plan::mode, by index): "smem" each block's frames and halo in
# shared-memory windows; "staged" the outputs in the device buffer
# ``act``, each sub-tile's window staged; "taps" the same, only the rows
# each tap reads staged, K slices of a sub-tile (a halo too long for
# either)
WINDOWS = ("smem", "staged", "taps")


def _pad_max(dilations: Sequence[int], kernel_size: int) -> int:
    return (kernel_size - 1) * max(dilations)


def thread_map(rows: int, c: int) -> Tuple[int, int]:
    """(rows_per_thread, splits) of the kernel's thread map (``Map`` in
    csrc/fused_mdtc.cu) for a block of ``rows`` frames: 256 threads as
    C / 4 channel quads x G row groups x ``splits`` halves of the
    reduction depth.  Two halves where one row a thread covers the rows
    with half the groups (a streaming chunk), else the fewest rows a
    thread (1 to 4) that cover them."""
    quads = c // 4
    if rows <= THREADS // (2 * quads):
        return 1, 2
    groups = THREADS // quads
    return next((r for r in (1, 2, 3, 4) if groups * r >= rows), 4), 1


def mdtc_smem_bytes(t: int, c: int, kernel_size: int, pad_max: int,
                    cluster: int, rows_per_thread: int, splits: int,
                    window: str, nbuf: int) -> int:
    """Shared memory one block of the kernel takes
    (``fused_mdtc_smem_bytes`` in csrc/fused_mdtc.cu): ``nbuf`` weight
    buffers (W1, W2, taps, biases), the layer input's windows by
    ``window`` (two of [P halo rows | the block's rows], one staged
    window of a sub-tile, or K slices of a sub-tile's rows), the
    sub-tile's conv (then hidden)
    tile at row stride C + 4, two mbarriers."""
    rows = -(-t // cluster)
    tile = THREADS // (splits * (c // 4)) * rows_per_thread
    wsize = 2 * c * c + (kernel_size + 3) * c
    span = {"smem": 2 * (pad_max + rows), "staged": pad_max + tile,
            "taps": kernel_size * tile}[window]
    return 4 * (nbuf * wsize + span * c + tile * (c + 4) + 4)


def fit_plan(t: int, c: int, kernel_size: int, pad_max: int, cluster: int,
             spread: bool) -> Optional[dict]:
    """The plan of ``cluster`` blocks a batch row, each owning ``rows``
    = ceil(T / cluster) frames in sub-tiles of ``tile`` rows
    (``thread_map``): the first that fits a block's shared memory, in
    this order of preference: ``WINDOWS``; the thread map's rows a
    thread (else fewer); two weight buffers (else one).  ``spread``:
    each block asks for at least ``SPREAD_SMEM`` bytes, an SM of its
    own.  None where nothing fits."""
    rows = -(-t // cluster)
    widest, splits = thread_map(rows, c)
    for window in WINDOWS:
        for rpt in range(widest, 0, -1):
            for nbuf in (2, 1):
                smem = mdtc_smem_bytes(t, c, kernel_size, pad_max, cluster,
                                       rpt, splits, window, nbuf)
                if smem <= SMEM_LIMIT:
                    return {"cluster": cluster, "rows": rows,
                            "rows_per_thread": rpt, "splits": splits,
                            "tile": THREADS // (splits * (c // 4)) * rpt,
                            "window": window, "nbuf": nbuf,
                            "spread": spread,
                            "smem": max(smem, SPREAD_SMEM) if spread
                            else smem}
    return None


def mdtc_plan(batch: int, t: int, c: int, kernel_size: int, pad_max: int,
              resident: Optional[Callable[[dict], int]] = None) -> dict:
    """The kernel's plan for these shapes, chosen before the launch
    (``fit_plan`` for the cluster size).  Given ``resident(plan)`` (how
    many clusters of the plan fit the card at once), the largest cluster
    of up to ``MAX_CLUSTER`` blocks, at least ``MIN_ROWS`` frames a block
    and no more blocks than SMs whose spread clusters all fit at once;
    else (or without ``resident``) the largest power of two up to
    ``MAX_CLUSTER`` with at least ``MIN_ROWS`` frames a block and about
    two blocks an SM over the batch, not spread.  Raises where nothing
    fits."""
    if resident is not None:
        for n in range(MAX_CLUSTER, 1, -1):
            if -(-t // n) < MIN_ROWS or batch * n > SMS:
                continue
            plan = fit_plan(t, c, kernel_size, pad_max, n, True)
            if plan is not None and resident(plan) >= batch:
                return plan
    limit = min(MAX_CLUSTER, max(1, 2 * SMS // batch),
                max(1, -(-t // MIN_ROWS)))
    plan = fit_plan(t, c, kernel_size, pad_max, 1 << int(math.log2(limit)),
                    False)
    if plan is None:
        raise ValueError(f"no MDTC kernel plan fits a block's shared memory "
                         f"at T={t}, C={c}, K={kernel_size}, "
                         f"pad_max={pad_max}")
    return plan


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
        mdtc_plan(b, t, c, k, _pad_max(dilations, k))
        tensors = (x, cache) + tuple(weights)
        if any(w is not None and w.data_ptr() % 16 for w in tensors):
            raise ValueError("the CUDA kernel's bulk copies need every "
                             "tensor 16-byte aligned")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")


def _kernel_fn():
    lib = cuda_build.load("fused_mdtc")
    fn = lib.fused_mdtc_launch
    if fn.argtypes is None:  # without argtypes ctypes cuts pointers to int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_mdtc_max_clusters.argtypes = [ctypes.c_int] * 5
        lib.fused_mdtc_max_clusters.restype = ctypes.c_int
        lib.fused_mdtc_error_string.argtypes = [ctypes.c_int]
        lib.fused_mdtc_error_string.restype = ctypes.c_char_p
    return lib, fn


# plans chosen on this card, by (B, T, C, K, pad_max, device)
_plans: Dict[tuple, dict] = {}


def _card_plan(b, t, c, kernel_size, pad_max):
    """``mdtc_plan`` with the card's answer to how many clusters fit."""
    key = (b, t, c, kernel_size, pad_max, torch.cuda.current_device())
    if key not in _plans:
        lib, _ = _kernel_fn()

        def resident(plan):
            return lib.fused_mdtc_max_clusters(
                c, plan["rows_per_thread"], plan["splits"], plan["cluster"],
                plan["smem"])

        _plans[key] = mdtc_plan(b, t, c, kernel_size, pad_max, resident)
    return _plans[key]


def _launch(x, cache, weights, dilations, kernel_size, stack_size, plan):
    """One kernel launch under ``plan`` on x's device and current
    stream."""
    lib, fn = _kernel_fn()
    b, t, c = x.shape
    n_layers = len(dilations)
    pad_max = _pad_max(dilations, kernel_size)
    out = torch.empty_like(x)
    # fresh output cache: the kernel reads cache_in[l] while writing
    # cache_out[l], so the two must never alias
    cache_out = torch.empty_like(cache) if cache is not None else None
    # the layer outputs of a plan whose frames do not fit shared memory
    act = (None if plan["window"] == "smem" else
           torch.empty((b, 2, t, c), dtype=torch.float32, device=x.device))
    dil = (ctypes.c_int * n_layers)(*[int(d) for d in dilations])
    ptr = [w.data_ptr() for w in weights]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(),
                 cache.data_ptr() if cache is not None else None,
                 *ptr, out.data_ptr(),
                 cache_out.data_ptr() if cache_out is not None else None,
                 act.data_ptr() if act is not None else None, b, t, c,
                 n_layers, kernel_size, stack_size, pad_max, dil,
                 plan["cluster"], plan["rows_per_thread"], plan["splits"],
                 WINDOWS.index(plan["window"]), plan["nbuf"],
                 plan["smem"] if plan["spread"] else 0, stream)
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
    plan = _card_plan(*x.shape, kernel_size, _pad_max(dilations, kernel_size))
    out, _ = _launch(x, None, weights, dilations, kernel_size, stack_size,
                     plan)
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
    plan = _card_plan(*x.shape, kernel_size, _pad_max(dilations, kernel_size))
    out, new_cache = _launch(x, cache, weights, dilations, kernel_size,
                             stack_size, plan)
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
