"""Whole-backbone fused FSMN layer chain: CUDA kernel and plain version.

The JAX package runs the FSMN's layer chain as one Pallas program
(wekws_tpu/ops/fused_fsmn.py); here the same function is the
hand-written Hopper kernel ``csrc/fused_fsmn.cu``, launched through
``ctypes``.  Per layer: ``cur @ proj_w`` (no bias), the window
``[cache; p]``, identity + ``lorder`` left taps + ``rorder``
look-ahead taps, ``relu(o @ aff_w + aff_b)``; the new cache is the last
``P = (lorder-1)*lstride + rorder*rstride`` projected frames.  The
in/out linear pairs stay outside the kernel (``fused_fsmn_forward``),
as in the JAX package.

Layouts are the JAX package's: ``x (B, T, linear_dim)``, ``cache
(L, B, P, proj_dim)``, ``proj_w (L, linear_dim, proj_dim)``, ``wl
(L, lorder, proj_dim)``, ``wr (L, max(rorder, 1), proj_dim)`` (a dummy
row when ``rorder == 0``), ``aff_w (L, proj_dim, linear_dim)``,
``aff_b (L, linear_dim)``.

The kernel runs one thread-block cluster of CLUSTER blocks per batch
row; block k owns a slice of the proj channels and of the affine
output columns (``cluster_slices``) and holds only its slices of the
weights, which it brings in as contiguous runs by the copy engine from
``pack_fsmn_weights(proj_w, aff_w)`` (build_fused_forward packs once
and passes ``packed``; without it the wrapper packs on every call).
``fused_fsmn_smem_bytes`` mirrors the kernel's shared memory.

``fused_fsmn_layers`` takes the plain PyTorch version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises (also
when no cluster of that size can be resident on the card).  It counts
its kernel launches in ``fused_fsmn_layers.launches``.  The JAX
function's ``block_batch`` (a TPU tiling knob) has no counterpart.
"""

import ctypes
from typing import Optional, Tuple

import torch

from wekws_tpu_torch.ops import cuda_build
from wekws_tpu_torch.ops.fused_common import check_tensor

MAX_WIDTH = 256  # linear_dim and proj_dim the CUDA kernel takes
MAX_SHARED_BYTES = 232448  # what one block may use on an H100
# blocks of a cluster (one cluster per batch row); the kernel also takes
# 16, the non-portable size (wekws_tpu_torch/tools/time_fsmn.py times it)
CLUSTER = 8
TILE_ROWS = 16  # rows of a time tile (``kRows``)
SPLITS = 4  # splits of a product's reduction depth (``kSplits``)
MAX_SLICE = 32  # widest slice a block owns (``kMaxSlice``)


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def slice_width(n: int, cluster: int) -> int:
    """Columns of n one block of the cluster owns: ceil(n / cluster),
    rounded up to a multiple of 4 (the kernel's ``slice_width``)."""
    return _round4(-(-n // cluster))


def cluster_slices(n: int, cluster: int):
    """[(begin, end)] of the n columns each block of the cluster owns,
    in rank order (``cluster_slice`` in csrc/fused_fsmn.cu): equal
    widths but the last owner's, which is ragged; owners past the end
    hold an empty slice."""
    width = slice_width(n, cluster)
    return [(min(k * width, n), min((k + 1) * width, n))
            for k in range(cluster)]


def fused_fsmn_smem_bytes(ld, pd, lorder, rorder, lstride=1, rstride=1,
                          cluster=CLUSTER):
    """Shared memory of one block of the kernel (csrc/fused_fsmn.cu
    ``layout``): two weight buffers (the proj and aff slices, the taps,
    the bias), a time tile's rows of cur, two o buffers, three windows
    of P + TILE_ROWS frames of the own channels, the products' partial
    sums, and two mbarriers (16 bytes)."""
    pc, lc = slice_width(pd, cluster), slice_width(ld, cluster)
    ldp, pdp = _round4(ld), _round4(pd)
    pad = (lorder - 1) * lstride + rorder * rstride
    wsize = ldp * pc + pdp * lc + (lorder + max(rorder, 1)) * pc + lc

    rows = TILE_ROWS
    return 4 * (2 * wsize + rows * ldp + 2 * rows * pdp
                + 3 * (pad + rows) * pc + SPLITS * rows * MAX_SLICE) + 16


def pack_fsmn_weights(proj_w, aff_w):
    """proj_w (L, LD, PD) and aff_w (L, PD, LD) -> (L, CLUSTER, LD, pc)
    and (L, CLUSTER, PD, lc): block k's column slice of each layer as one
    contiguous run, zero past the matrix's last column."""
    def pack(w):
        n_layers, rows, n = w.shape
        out = w.new_zeros((n_layers, CLUSTER, rows, slice_width(n, CLUSTER)))
        for k, (b, e) in enumerate(cluster_slices(n, CLUSTER)):
            out[:, k, :, :e - b] = w[:, :, b:e]
        return out.contiguous()

    return pack(proj_w), pack(aff_w)


def fused_fsmn_layers_plain(x, cache, proj_w, wl, wr, aff_w, aff_b, lorder,
                            rorder, lstride=1, rstride=1):
    """Eager PyTorch version of the kernel."""
    t = x.shape[1]
    pad = (lorder - 1) * lstride + rorder * rstride
    start = (lorder - 1) * lstride
    cur = x
    new_cache = []
    for layer in range(cache.shape[0]):
        p = torch.matmul(cur, proj_w[layer])
        ext = torch.cat([cache[layer], p], dim=1)  # (B, P + T, proj)
        new_cache.append(ext[:, t:t + pad])
        # identity path aligned with the rorder-delayed output
        o = ext[:, start:start + t]
        for tap in range(lorder):
            off = tap * lstride
            o = o + ext[:, off:off + t] * wl[layer, tap]
        for tap in range(rorder):
            off = start + rstride + tap * rstride
            o = o + ext[:, off:off + t] * wr[layer, tap]
        cur = torch.relu(torch.matmul(o, aff_w[layer]) + aff_b[layer])
    return cur, torch.stack(new_cache)


def _validate(x, cache, weights, lorder, rorder, lstride, rstride):
    if x.dim() != 3 or cache.dim() != 4:
        raise ValueError(f"x must be (B, T, linear_dim) and cache (L, B, P, "
                         f"proj_dim), got {tuple(x.shape)} and "
                         f"{tuple(cache.shape)}")
    b, t, ld = x.shape
    n_layers, _, _, pd = cache.shape
    if b < 1 or t < 1 or n_layers < 1:
        raise ValueError("empty batch, chunk or layer list")
    if lorder < 1 or rorder < 0 or lstride < 1 or rstride < 1:
        raise ValueError("lorder, lstride, rstride must be >= 1, rorder >= 0")
    pad = (lorder - 1) * lstride + rorder * rstride
    dev = x.device
    check_tensor("x", x, (b, t, ld), dev)
    check_tensor("cache", cache, (n_layers, b, pad, pd), dev)
    shapes = ((n_layers, ld, pd), (n_layers, lorder, pd),
              (n_layers, max(rorder, 1), pd), (n_layers, pd, ld),
              (n_layers, ld))
    for name, w, shape in zip(("proj_w", "wl", "wr", "aff_w", "aff_b"),
                              weights, shapes):
        check_tensor(name, w, shape, dev)
    if dev.type == "cuda":
        if ld > MAX_WIDTH or pd > MAX_WIDTH:
            raise ValueError(f"the CUDA kernel takes linear_dim and proj_dim "
                             f"up to {MAX_WIDTH}, got {ld} and {pd}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")


def _kernel_fn():
    lib = cuda_build.load("fused_fsmn")
    fn = lib.fused_fsmn_launch
    if fn.argtypes is None:  # without argtypes ctypes cuts pointers to int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_fsmn_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.fused_fsmn_smem_bytes.restype = ctypes.c_int
        lib.fused_fsmn_error_string.argtypes = [ctypes.c_int]
        lib.fused_fsmn_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(x, cache, weights, lorder, rorder, lstride, rstride, packed):
    """One kernel launch on x's device and current stream."""
    lib, fn = _kernel_fn()
    b, t, ld = x.shape
    n_layers, _, pad, pd = cache.shape
    need = lib.fused_fsmn_smem_bytes(ld, pd, lorder, rorder, lstride,
                                     rstride, CLUSTER)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"the CUDA kernel needs {need} bytes of shared memory at "
            f"linear_dim {ld}, proj_dim {pd}, {lorder}+{rorder} taps; a "
            f"block has {MAX_SHARED_BYTES}")
    _, wl, wr, _, aff_b = weights
    proj_w, aff_w = packed
    out = torch.empty_like(x)
    # fresh output cache: with T < P it overlaps the input cache in time
    cache_out = torch.empty_like(cache)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), cache.data_ptr(),
                 *[w.data_ptr() for w in (proj_w, wl, wr, aff_w, aff_b)],
                 out.data_ptr(), cache_out.data_ptr(), b, t, n_layers, ld,
                 pd, lorder, rorder, lstride, rstride, CLUSTER, stream)
    if err != 0:
        msg = lib.fused_fsmn_error_string(err).decode()
        raise RuntimeError(f"fused_fsmn kernel launch failed: {msg} ({err})")
    return out, cache_out


def fused_fsmn_layers(
    x: torch.Tensor,
    cache: torch.Tensor,
    proj_w: torch.Tensor,
    wl: torch.Tensor,
    wr: torch.Tensor,
    aff_w: torch.Tensor,
    aff_b: torch.Tensor,
    lorder: int,
    rorder: int,
    lstride: int = 1,
    rstride: int = 1,
    *,
    packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the full FSMN layer chain fused.

    x: (B, T, linear_dim), the output of in_linear2 + ReLU; cache:
    (L, B, P, proj_dim) carried context (zeros at start).  Returns
    (y (B, T, linear_dim), new_cache); chunked calls equal one
    whole-utterance call.  The new cache is a fresh tensor.  On CUDA:
    linear_dim and proj_dim up to 256.  ``packed``:
    ``pack_fsmn_weights(proj_w, aff_w)``, the form the kernel reads the
    matrices in (packed here when not given); the plain version ignores
    it."""
    weights = (proj_w, wl, wr, aff_w, aff_b)
    _validate(x, cache, weights, lorder, rorder, lstride, rstride)
    if packed is not None:
        n_layers, ld, pd = proj_w.shape
        for name, ten, shape in (
                ("packed proj_w", packed[0],
                 (n_layers, CLUSTER, ld, slice_width(pd, CLUSTER))),
                ("packed aff_w", packed[1],
                 (n_layers, CLUSTER, pd, slice_width(ld, CLUSTER)))):
            check_tensor(name, ten, shape, x.device)
    if x.device.type == "cpu":
        return fused_fsmn_layers_plain(x, cache, *weights, lorder, rorder,
                                       lstride, rstride)
    if packed is None:
        packed = pack_fsmn_weights(proj_w, aff_w)
    out = _launch(x, cache, weights, lorder, rorder, lstride, rstride,
                  packed)
    fused_fsmn_layers.launches += 1
    return out


fused_fsmn_layers.launches = 0


def init_fsmn_cache(n_layers: int, batch: int, pad: int, proj_dim: int,
                    device="cpu") -> torch.Tensor:
    return torch.zeros((n_layers, batch, pad, proj_dim), dtype=torch.float32,
                       device=device)


def extract_fsmn_weights(fsmn):
    """Port FSMN module -> float32 CPU weights, matrices input-first.

    Returns (in1_w, in1_b, in2_w, in2_b, proj_w, wl, wr, aff_w, aff_b,
    out1_w, out1_b, out2_w, out2_b); the five in the middle are stacked
    over layers."""
    def lin(mod):
        return (mod.linear.weight.detach().t().contiguous().float(),
                mod.linear.bias.detach().float())

    proj_w, wl, wr, aff_w, aff_b = [], [], [], [], []
    for proj, block, affine, _ in fsmn.fsmn:
        proj_w.append(proj.linear.weight.detach().t())
        wl.append(block.conv_left.weight.detach()[:, 0, :, 0].t())
        if block.conv_right is not None:
            wr.append(block.conv_right.weight.detach()[:, 0, :, 0].t())
        else:
            wr.append(torch.zeros((1, fsmn.proj_dim)))
        aff_w.append(affine.linear.weight.detach().t())
        aff_b.append(affine.linear.bias.detach())

    def stack(ts):
        return torch.stack(ts).float().cpu().contiguous()

    return (*lin(fsmn.in_linear1), *lin(fsmn.in_linear2), stack(proj_w),
            stack(wl), stack(wr), stack(aff_w), stack(aff_b),
            *lin(fsmn.out_linear1), *lin(fsmn.out_linear2))


def fused_fsmn_forward(
    fsmn, x: torch.Tensor, cache: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full FSMN forward: in/out linears as matmuls, layer chain fused.

    x: (B, T, idim) features on the module's device.  Returns (logits
    (B, T, odim), new_cache (L, B, P, proj_dim))."""
    dev = x.device
    (in1_w, in1_b, in2_w, in2_b, proj_w, wl, wr, aff_w, aff_b,
     out1_w, out1_b, out2_w, out2_b) = (
        w.to(dev) for w in extract_fsmn_weights(fsmn))
    if cache is None:
        cache = init_fsmn_cache(fsmn.fsmn_layers, x.shape[0],
                                fsmn.layer_padding, fsmn.proj_dim, dev)
    with torch.no_grad():
        h = torch.relu((x @ in1_w + in1_b) @ in2_w + in2_b)
        h, new_cache = fused_fsmn_layers(
            h.contiguous(), cache, proj_w, wl, wr, aff_w, aff_b,
            fsmn.lorder, fsmn.rorder, fsmn.lstride, fsmn.rstride)
        y = (h @ out1_w + out1_b) @ out2_w + out2_b
    return y, new_cache
