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
cluster of the plan's size can be resident on the card.  The same
kernel body runs the DS-TCN layer (``ops/fused_tcn.py``): the plan
functions take the layer (``ARCHS``) and size its weights by
``weight_floats``.
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
# the layers the kernel body runs (its Arch, by index): MDTC's block (two
# C x C products) and DS-TCN's (one)
ARCHS = ("mdtc", "ds_tcn")
# the widest C whose C x C weights a block holds; a DS-TCN W above it
# streams through two slices of SLICE_ROWS input rows
MAX_RESIDENT = 128
SLICE_ROWS = 32
# rows a thread of the thread map the kernel is built for; where W
# streams in slices also 6, 8 and 9: one sub-tile covers a block's
# frames, so that each slice of W serves them all
ROWS_PER_THREAD = (1, 2, 3, 4)
SLICED_ROWS_PER_THREAD = (1, 2, 3, 4, 6, 8, 9)


def _pad_max(dilations: Sequence[int], kernel_size: int) -> int:
    return (kernel_size - 1) * max(dilations)


def sliced(arch: str, c: int) -> bool:
    """Whether the layer's W streams through the kernel in slices."""
    return arch == "ds_tcn" and c > MAX_RESIDENT


def rows_choices(c: int, arch: str = "mdtc") -> Tuple[int, ...]:
    return SLICED_ROWS_PER_THREAD if sliced(arch, c) else ROWS_PER_THREAD


def row_groups(c: int, splits: int) -> int:
    """G of the kernel's thread map: row groups of 256 threads as C / 4
    channel quads x ``splits``; the THREADS - G splits C / 4 threads
    left over (C = 48: 4, or 16 split) are idle."""
    return THREADS // (splits * (c // 4))


def thread_map(rows: int, c: int, arch: str = "mdtc") -> Tuple[int, int]:
    """(rows_per_thread, splits) of the kernel's thread map (``Map`` in
    csrc/fused_mdtc.cu) for a block of ``rows`` frames: 256 threads as
    C / 4 channel quads x G row groups x ``splits`` halves of the
    reduction depth.  Two halves where one row a thread covers the rows
    with half the groups (a streaming chunk), else the fewest rows a
    thread (``rows_choices``) that cover them."""
    if rows <= row_groups(c, 2):
        return 1, 2
    choices = rows_choices(c, arch)
    groups = row_groups(c, 1)
    return next((r for r in choices if groups * r >= rows), choices[-1]), 1


def weight_floats(arch: str, c: int, kernel_size: int) -> Tuple[int, int]:
    """Floats of one weight buffer of the layer ``arch`` (its C x C
    matrices where a block holds them, taps, biases) and of the ring of W
    slices (0 where W is resident): ``Layout`` in csrc/fused_mdtc.cu."""
    if arch == "mdtc":
        return 2 * c * c + (kernel_size + 3) * c, 0
    if sliced(arch, c):
        return (kernel_size + 2) * c, 2 * SLICE_ROWS * c
    return c * c + (kernel_size + 2) * c, 0


def mdtc_smem_bytes(t: int, c: int, kernel_size: int, pad_max: int,
                    cluster: int, rows_per_thread: int, splits: int,
                    window: str, nbuf: int, arch: str = "mdtc") -> int:
    """Shared memory one block of the kernel takes
    (``fused_mdtc_smem_bytes`` / ``fused_ds_tcn_smem_bytes`` in
    csrc/fused_mdtc.cu): ``nbuf`` weight buffers and the ring of W
    slices (``weight_floats``), the layer input's windows by ``window``
    (two of [P halo rows | the block's rows], one staged window of a
    sub-tile, or K slices of a sub-tile's rows), the sub-tile's conv
    (then hidden) tile at row stride C + 4, two mbarriers (four with W
    slices)."""
    rows = -(-t // cluster)
    tile = row_groups(c, splits) * rows_per_thread
    wsize, ring = weight_floats(arch, c, kernel_size)
    span = {"smem": 2 * (pad_max + rows), "staged": pad_max + tile,
            "taps": kernel_size * tile}[window]
    bars = 8 if ring else 4
    return 4 * (nbuf * wsize + ring + span * c + tile * (c + 4) + bars)


def fit_plan(t: int, c: int, kernel_size: int, pad_max: int, cluster: int,
             spread: bool, arch: str = "mdtc") -> Optional[dict]:
    """The plan of ``cluster`` blocks a batch row, each owning ``rows``
    = ceil(T / cluster) frames in sub-tiles of ``tile`` rows
    (``thread_map``): the first that fits a block's shared memory, in
    this order of preference: ``WINDOWS``; the thread map's rows a
    thread (else fewer); two weight buffers (else one).  ``spread``:
    each block asks for at least ``SPREAD_SMEM`` bytes, an SM of its
    own.  None where nothing fits."""
    rows = -(-t // cluster)
    widest, splits = thread_map(rows, c, arch)
    for window in WINDOWS:
        for rpt in [r for r in rows_choices(c, arch) if r <= widest][::-1]:
            for nbuf in (2, 1):
                smem = mdtc_smem_bytes(t, c, kernel_size, pad_max, cluster,
                                       rpt, splits, window, nbuf, arch)
                if smem <= SMEM_LIMIT:
                    return {"cluster": cluster, "rows": rows,
                            "rows_per_thread": rpt, "splits": splits,
                            "tile": row_groups(c, splits) * rpt,
                            "window": window, "nbuf": nbuf,
                            "spread": spread,
                            "smem": max(smem, SPREAD_SMEM) if spread
                            else smem}
    return None


def mdtc_plan(batch: int, t: int, c: int, kernel_size: int, pad_max: int,
              resident: Optional[Callable[[dict], int]] = None,
              arch: str = "mdtc") -> dict:
    """The kernel's plan for these shapes and the layer ``arch``, chosen
    before the launch (``fit_plan`` for the cluster size).  Given
    ``resident(plan)`` (how many clusters of the plan fit the card at
    once), the largest cluster of up to ``MAX_CLUSTER`` blocks, at least
    ``MIN_ROWS`` frames a block and no more blocks than SMs whose spread
    clusters all fit at once; else (or without ``resident``) the largest
    power of two up to ``MAX_CLUSTER`` with at least ``MIN_ROWS`` frames
    a block and about two blocks an SM over the batch, not spread.
    Raises where nothing fits."""
    if resident is not None:
        for n in range(MAX_CLUSTER, 1, -1):
            if -(-t // n) < MIN_ROWS or batch * n > SMS:
                continue
            plan = fit_plan(t, c, kernel_size, pad_max, n, True, arch)
            if plan is not None and resident(plan) >= batch:
                return plan
    limit = min(MAX_CLUSTER, max(1, 2 * SMS // batch),
                max(1, -(-t // MIN_ROWS)))
    plan = fit_plan(t, c, kernel_size, pad_max, 1 << int(math.log2(limit)),
                    False, arch)
    if plan is None:
        raise ValueError(f"no {arch} kernel plan fits a block's shared "
                         f"memory at T={t}, C={c}, K={kernel_size}, "
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


def kernel_lib():
    """The loaded library of csrc/fused_mdtc.cu, its entries typed."""
    lib = cuda_build.load("fused_mdtc")
    if lib.fused_mdtc_launch.argtypes is None:
        # without argtypes ctypes cuts pointers to int
        lib.fused_mdtc_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
            + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        lib.fused_ds_tcn_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        for arch in ARCHS:
            getattr(lib, f"fused_{arch}_launch").restype = ctypes.c_int
            clusters = getattr(lib, f"fused_{arch}_max_clusters")
            clusters.argtypes = [ctypes.c_int] * 5
            clusters.restype = ctypes.c_int
        lib.fused_mdtc_error_string.argtypes = [ctypes.c_int]
        lib.fused_mdtc_error_string.restype = ctypes.c_char_p
    return lib


# plans chosen on this card, by (arch, B, T, C, K, pad_max, device)
_plans: Dict[tuple, dict] = {}


def card_plan(b, t, c, kernel_size, pad_max, arch="mdtc"):
    """``mdtc_plan`` with the card's answer to how many clusters of the
    layer ``arch``'s kernel fit."""
    key = (arch, b, t, c, kernel_size, pad_max, torch.cuda.current_device())
    if key not in _plans:
        clusters = getattr(kernel_lib(), f"fused_{arch}_max_clusters")

        def resident(plan):
            return clusters(c, plan["rows_per_thread"], plan["splits"],
                            plan["cluster"], plan["smem"])

        _plans[key] = mdtc_plan(b, t, c, kernel_size, pad_max, resident,
                                arch)
    return _plans[key]


def plan_args(plan):
    """The plan's launch arguments after the dilations, before the
    stream: cluster, rows a thread, splits, window, weight buffers, the
    shared-memory floor."""
    return (plan["cluster"], plan["rows_per_thread"], plan["splits"],
            WINDOWS.index(plan["window"]), plan["nbuf"],
            plan["smem"] if plan["spread"] else 0)


def raise_on_error(lib, err, name):
    if err != 0:
        msg = lib.fused_mdtc_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def _launch(x, cache, weights, dilations, kernel_size, stack_size, plan):
    """One kernel launch under ``plan`` on x's device and current
    stream."""
    lib = kernel_lib()
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
        err = lib.fused_mdtc_launch(
            x.data_ptr(), cache.data_ptr() if cache is not None else None,
            *ptr, out.data_ptr(),
            cache_out.data_ptr() if cache_out is not None else None,
            act.data_ptr() if act is not None else None, b, t, c, n_layers,
            kernel_size, stack_size, pad_max, dil, *plan_args(plan), stream)
    raise_on_error(lib, err, "fused_mdtc")
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
    plan = card_plan(*x.shape, kernel_size, _pad_max(dilations, kernel_size))
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
    plan = card_plan(*x.shape, kernel_size, _pad_max(dilations, kernel_size))
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
