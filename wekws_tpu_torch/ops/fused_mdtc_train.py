"""Fused TCNBlock training step with exact BatchNorm: CUDA kernels and
their plain versions.

Port of wekws_tpu/ops/fused_mdtc_train.py.  One MDTC block in training
mode,

    u  = dwconv_d(x)          # depthwise, K taps, dilation d, causal
    s0 = bn0(u)               # exact global-batch statistics
    v  = s0 @ W1 + b1         # pointwise
    r  = relu(bn1(v))
    w  = r @ W2 + b2          # pointwise
    y  = relu(bn2(w) + x)     # residual

runs as eight passes over the (B, T, C) activations, each a kernel of
``csrc/fused_mdtc_train.cu``.  Exact BN needs one global reduction per
BN layer, so the passes end where a batch statistic is needed:

  forward   F1 read x        -> (su, suu)                  bn0 stats
            F2 read x        -> (sv, svv)                  bn1 stats
            F3 read x        -> write r, w; (sw, sww)      bn2 stats
            F4 read w, x     -> write y
  backward  B1 read dy,w,x   -> (sg, sgw)                  bn2 grad sums
            B2 read dy,w,x,r -> dW2, db2, (sds1, sds1v)    bn1 grad sums
            B3 read dy,w,x,r -> dW1, db1, (sds0, sds0u)    bn0 grad sums;
                                write ds0
            B4 read dy,w,x,ds0 -> dWd, dbd, write dx

B3 holds ds0 = dv W1^T for every frame when it sums it, so it also
writes it, and B4 (which the TPU kernel makes recompute all of B3) needs
no C x C product: on this card one more (B, T, C) tensor written and
read costs less than three products per frame.  g2 is not handed over:
B4 recomputes it from dy, w and x (one compare and select per element),
which moves the same bytes as reading it.

The few per-channel ops between the passes (means, variances, the
folded scales) stay plain PyTorch, as the JAX package leaves them to
XLA between its ``pallas_call``s.  Each pass has a plain PyTorch
version (``_f1_plain`` ... ``_b4_plain``); a pass takes it only for
CPU tensors and launches its kernel (or raises) for CUDA tensors.
``PASSES`` maps each pass name to its public function, which counts
its kernel launches in ``.launches`` and carries its plain version as
``.plain``.  ``trace_pass_inputs``, ``compare_pass`` and
``compare_sums`` hold each kernel against its plain version on the
same inputs, for the tests and ``chip_smoke.py``.

Gradients are the textbook exact-BN backward per layer composed
through the block; they equal autograd of the unfused block
(``models/mdtc.py``), which the tests pin.  ``fused_tcn_block_train``
is the ``torch.autograd.Function`` around the eight passes.
"""

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from wekws_tpu_torch.ops import cuda_build

KERNEL_CHANNELS = (32, 64, 128)
MAX_TAPS = 8
PARAM_KEYS = (
    "dw_kernel", "dw_bias", "bn0_scale", "bn0_bias",
    "pw1_kernel", "pw1_bias", "bn1_scale", "bn1_bias",
    "pw2_kernel", "pw2_bias", "bn2_scale", "bn2_bias",
)
# rows of the packed (len(VEC_KEYS), C) per-channel vector the kernels
# read; the order is csrc/fused_mdtc_train.cu's `Vec` enum
VEC_KEYS = (
    "dw_b", "a0", "c0", "mu0", "inv0", "b1", "a1", "c1", "mu1", "inv1",
    "coef1", "b2", "a2", "c2", "mu2", "inv2", "coef2", "sg", "sgw",
    "sds1", "sds1v", "beta1", "gamma1", "coef0", "sds0", "sds0u",
)
PASS_IDS = {"f1": 1, "f2": 2, "f3": 3, "f4": 4,
            "b1": 5, "b2": 6, "b3": 7, "b4": 8}


def kernel_name(name: str, c: int) -> str:
    """The CUDA kernel of pass ``name`` at C channels, as a profiler
    names it (its block reduction is ``reduce_kernel<PASS_IDS[name]>``)."""
    return {"f1": f"fwd_kernel<{c}, 1>", "f2": f"fwd_kernel<{c}, 2>",
            "f3": f"f3_kernel<{c}>", "f4": f"f4_kernel<{c}>",
            "b1": f"b1_kernel<{c}>", "b2": f"b2_kernel<{c}>",
            "b3": f"b3_kernel<{c}>", "b4": f"b4_kernel<{c}>"}[name]


# ---------------------------------------------------------------------------
# plain versions: the same function as each kernel, in PyTorch
# ---------------------------------------------------------------------------


def _dw(x, dw_w, dw_b, dilation):
    """Causal depthwise conv: u[t] = sum_tap x[t - (K-1-tap) d] w[tap]."""
    t = x.shape[1]
    k = dw_w.shape[0]
    pad = (k - 1) * dilation
    xp = F.pad(x, (0, 0, pad, 0))
    u = None
    for tap in range(k):
        off = pad - (k - 1 - tap) * dilation
        term = xp[:, off:off + t] * dw_w[tap]
        u = term if u is None else u + term
    return u + dw_b


def _sums(z):
    return z.sum(dim=(0, 1)), (z * z).sum(dim=(0, 1))


def _f1_plain(x, dw_w, v, dilation):
    return _sums(_dw(x, dw_w, v["dw_b"], dilation))


def _pw1(x, dw_w, w1, v, dilation):
    u = _dw(x, dw_w, v["dw_b"], dilation)
    s0 = u * v["a0"] + v["c0"]
    return u, s0, torch.matmul(s0, w1) + v["b1"]


def _f2_plain(x, dw_w, w1, v, dilation):
    return _sums(_pw1(x, dw_w, w1, v, dilation)[2])


def _f3_plain(x, dw_w, w1, w2, v, dilation):
    vv = _pw1(x, dw_w, w1, v, dilation)[2]
    r = torch.relu(vv * v["a1"] + v["c1"])
    w = torch.matmul(r, w2) + v["b2"]
    return (r, w) + _sums(w)


def _f4_plain(w, x, v):
    return torch.relu(w * v["a2"] + v["c2"] + x)


def _g2(dy, w, x, v):
    """g2 = dy * relu'(bn2(w) + x)."""
    return dy * (w * v["a2"] + v["c2"] + x > 0.0)


def _g2_what(dy, w, x, v):
    """g2 and w-hat."""
    return _g2(dy, w, x, v), (w - v["mu2"]) * v["inv2"]


def _b1_plain(dy, w, x, v):
    g2, what = _g2_what(dy, w, x, v)
    return g2.sum(dim=(0, 1)), (g2 * what).sum(dim=(0, 1))


def _bn_back(coef, g, sg, sgh, hat, n):
    """Exact-BN backward: coef/N * (N*g - sum(g) - hat*sum(g*hat))."""
    return coef / n * (n * g - sg - hat * sgh)


def _ds1(dy, w, x, r, w2, v, n):
    g2, what = _g2_what(dy, w, x, v)
    dwg = _bn_back(v["coef2"], g2, v["sg"], v["sgw"], what, n)
    dr = torch.matmul(dwg, w2.t())
    return dwg, dr * (r > 0.0)


def _rows(z):
    return z.reshape(-1, z.shape[-1])


def _b2_plain(dy, w, x, r, w2, v, n):
    dwg, ds1 = _ds1(dy, w, x, r, w2, v, n)
    dw2 = torch.matmul(_rows(r).t(), _rows(dwg))
    # v-hat where ds1 != 0: there r = s1 = gamma1 * vhat + beta1
    vhat = (r - v["beta1"]) / v["gamma1"]
    return (dw2, dwg.sum(dim=(0, 1)), ds1.sum(dim=(0, 1)),
            (ds1 * vhat).sum(dim=(0, 1)))


def _ds0(dy, w, x, r, dw_w, w1, w2, v, dilation, n):
    _, ds1 = _ds1(dy, w, x, r, w2, v, n)
    u, s0, vv = _pw1(x, dw_w, w1, v, dilation)
    uhat = (u - v["mu0"]) * v["inv0"]
    vhat = (vv - v["mu1"]) * v["inv1"]
    dv = _bn_back(v["coef1"], ds1, v["sds1"], v["sds1v"], vhat, n)
    return s0, uhat, dv, torch.matmul(dv, w1.t())


def _b3_plain(dy, w, x, r, dw_w, w1, w2, v, dilation, n):
    s0, uhat, dv, ds0 = _ds0(dy, w, x, r, dw_w, w1, w2, v, dilation, n)
    dw1 = torch.matmul(_rows(s0).t(), _rows(dv))
    return (dw1, dv.sum(dim=(0, 1)), ds0.sum(dim=(0, 1)),
            (ds0 * uhat).sum(dim=(0, 1)), ds0)


def _b4_plain(dy, w, x, ds0, dw_w, v, dilation, n):
    g2 = _g2(dy, w, x, v)
    uhat = (_dw(x, dw_w, v["dw_b"], dilation) - v["mu0"]) * v["inv0"]
    du = _bn_back(v["coef0"], ds0, v["sds0"], v["sds0u"], uhat, n)
    t = x.shape[1]
    k = dw_w.shape[0]
    pad = (k - 1) * dilation
    xp = F.pad(x, (0, 0, pad, 0))
    dwd = torch.stack([
        (du * xp[:, pad - (k - 1 - tap) * dilation:][:, :t]).sum(dim=(0, 1))
        for tap in range(k)])
    # dx[t] = g2[t] + sum_tap du[t + (K-1-tap) d] w[tap]: the transpose
    # of the causal conv, plus the residual path
    dup = F.pad(du, (0, 0, 0, pad))
    dx = g2
    for tap in range(k):
        start = (k - 1 - tap) * dilation
        dx = dx + dup[:, start:start + t] * dw_w[tap]
    return dx, dwd, du.sum(dim=(0, 1))


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _kernel_fn():
    lib = cuda_build.load("fused_mdtc_train")
    fn = lib.fused_train_launch
    if fn.argtypes is None:  # without argtypes ctypes cuts pointers to int
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fused_train_error_string.argtypes = [ctypes.c_int]
        lib.fused_train_error_string.restype = ctypes.c_char_p
    return lib, fn


# pointer slots of the C interface, in order
_SLOTS = ("x", "dy", "w", "r", "dw", "pw1", "pw2", "vec", "out_r", "out_w",
          "out_y", "dx", "ds0", "partials", "reduced")
TILE_ROWS = 64
SMEM_LIMIT = 232448  # bytes of shared memory one block may take on sm_90
SM_SMEM = 233472  # bytes of shared memory of one SM; a block reserves 1024
# passes whose tiles cut the flattened B x T frames
FLAT_PASSES = ("f3", "b2", "b3")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def b4_smem_bytes(rows: int, c: int, halo: int) -> int:
    """Shared memory of one B4 block (csrc/fused_mdtc_train.cu
    ``b4_smem_bytes``): x rows with a halo each way, ds0 rows with the
    forward halo, dy and w rows, the taps; at least the block's
    reduction buffer."""
    staged = 4 * c * (4 * rows + 3 * halo + MAX_TAPS)
    return max(staged, 4 * 1024 * (MAX_TAPS + 1))


def b4_tile_rows(t: int, c: int, halo: int) -> int:
    """Frames of one utterance per B4 tile: the utterance cut into equal
    tiles of at most 64 rows, so that the ragged last tile is not mostly
    empty; halved while the tile and its halos overflow a block's shared
    memory."""
    rows = _cdiv(t, _cdiv(t, TILE_ROWS))
    while rows > 8 and b4_smem_bytes(rows, c, halo) > SMEM_LIMIT:
        rows = _cdiv(rows, 2)
    if b4_smem_bytes(rows, c, halo) > SMEM_LIMIT:
        raise ValueError(
            f"the B4 kernel stages a halo of (K-1)*dilation = {halo} frames "
            f"each way in shared memory; at C={c} that overflows a block's "
            f"{SMEM_LIMIT} bytes")
    return rows


def flat_tile_rows(c: int) -> int:
    """Rows of an F3, B2 or B3 tile: 64, or 32 at C=128, where the
    weight matrices leave shared memory for no more."""
    return 32 if c == 128 else TILE_ROWS


def f3_window_bytes(c: int, halo: int) -> int:
    """F3's staged window of x: a tile's rows and the causal halo
    (K-1) * dilation before them."""
    return 4 * c * (flat_tile_rows(c) + halo)


def tile_smem_bytes(name: str, c: int, halo: int = 0) -> int:
    """Shared memory of one F3, B2 or B3 block (csrc/fused_mdtc_train.cu
    ``f3_smem_bytes``, ``b2_smem_bytes``, ``b3_smem_bytes``): the packed
    per-channel vector (with the taps, but in B2), the C x C weight
    matrices and the tiles, at row stride C + 4; B2 adds the next
    tile's w, x and dy rows, staged; F3 its window of x
    (``f3_window_bytes``) where that fits a block (``run`` there decides
    the same), else it reads the taps from device memory."""
    ld = c + 4
    vec, mats, tiles = {
        "f3": (len(VEC_KEYS) + MAX_TAPS, 2, 2),
        "b2": (len(VEC_KEYS), 1, 2),
        "b3": (len(VEC_KEYS) + MAX_TAPS, 2, 4),
    }[name]
    smem = 4 * (vec * c + mats * c * ld + tiles * flat_tile_rows(c) * ld)
    if name == "b2":  # the next tile's w, x and dy rows, staged
        smem += 4 * 3 * flat_tile_rows(c) * c
    if name == "f3" and smem + f3_window_bytes(c, halo) <= SMEM_LIMIT:
        smem += f3_window_bytes(c, halo)
    return smem


def blocks_per_sm(smem: int, c: int) -> int:
    """Blocks of an F3, B2 or B3 launch that one SM holds at once: as
    many as its shared memory allows, at most the blocks that their
    ``__launch_bounds__`` plan registers for (two at C <= 64, one at
    C=128)."""
    return min(1 if c == 128 else 2, SM_SMEM // (smem + 1024))


def _tiles(name: str, b: int, t: int, c: int, rows: int) -> int:
    """Work units of one pass: F3, B2 and B3 tile the flattened B x T
    frames (``flat_tile_rows``), B4 cuts each utterance into
    ``rows``-frame tiles, the others into 64-frame tiles."""
    if name in FLAT_PASSES:
        return _cdiv(b * t, flat_tile_rows(c))
    if name == "b4":
        return b * _cdiv(t, rows)
    return b * _cdiv(t, TILE_ROWS)


def _grid_blocks(device: torch.device, tiles: int, per_sm: int = 2) -> int:
    """Persistent grid: ``per_sm`` blocks per SM, at most one per tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(tiles, per_sm * sms))


def _partial_width(name: str, c: int, k: int) -> int:
    if name in ("f1", "f2", "f3", "b1"):
        return 2 * c
    if name in ("b2", "b3"):
        return c * c + 3 * c
    if name == "b4":
        return k * c + c
    return 0


def _pack(v: Dict[str, torch.Tensor], c: int, device) -> torch.Tensor:
    zero = torch.zeros((c,), dtype=torch.float32, device=device)
    return torch.stack([v.get(key, zero).reshape(c) for key in VEC_KEYS])


def _launch(name, x, tensors, v, dilation, n, k):
    """One pass on x's device and current stream.  ``tensors`` holds the
    (B, T, C) inputs and weights by slot name; returns the outputs."""
    lib, fn = _kernel_fn()
    b, t, c = x.shape
    dev = x.device
    width = _partial_width(name, c, k)
    rows = (b4_tile_rows(t, c, (k - 1) * int(dilation)) if name == "b4"
            else TILE_ROWS)
    per_sm = 2
    if name in FLAT_PASSES:
        smem = tile_smem_bytes(name, c, (k - 1) * int(dilation))
        per_sm = blocks_per_sm(smem, c)
    nblocks = _grid_blocks(dev, _tiles(name, b, t, c, rows), per_sm)
    ptrs = dict(tensors)
    ptrs["vec"] = _pack(v, c, dev)
    out = {}
    if name == "f3":
        out["out_r"] = torch.empty_like(x)
        out["out_w"] = torch.empty_like(x)
    elif name == "f4":
        out["out_y"] = torch.empty_like(x)
    elif name == "b3":
        out["ds0"] = torch.empty_like(x)
    elif name == "b4":
        out["dx"] = torch.empty_like(x)
    if width:
        out["partials"] = torch.empty((nblocks, width), dtype=torch.float32,
                                      device=dev)
        out["reduced"] = torch.empty((width,), dtype=torch.float32,
                                     device=dev)
    ptrs.update(out)
    arr = (ctypes.c_void_p * len(_SLOTS))(
        *[ptrs[s].data_ptr() if s in ptrs else None for s in _SLOTS])
    dims = (ctypes.c_int * 7)(c, b, t, k, int(dilation), nblocks, rows)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(PASS_IDS[name], arr, dims, float(n), stream)
    if err != 0:
        msg = lib.fused_train_error_string(err).decode()
        raise RuntimeError(f"fused_mdtc_train {name} kernel launch failed: "
                           f"{msg} ({err})")
    PASSES[name].launches += 1
    return out


def _check(x, mats, v, k):
    """Inputs of one pass: float32, contiguous, on x's device."""
    if x.dim() != 3:
        raise ValueError(f"activations must be (B, T, C), got "
                         f"{tuple(x.shape)}")
    b, t, c = x.shape
    if b < 1 or t < 1:
        raise ValueError("empty batch or utterance")
    for name, ten in list(mats.items()) + list(v.items()):
        if not isinstance(ten, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor")
        if ten.device != x.device:
            raise ValueError(f"{name} is on {ten.device}, expected "
                             f"{x.device}")
        if ten.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {ten.dtype}, expected "
                            "float32")
        if not ten.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, ten in mats.items():
        want = (k, c) if name == "dw" else (
            (c, c) if name in ("pw1", "pw2") else (b, t, c))
        if tuple(ten.shape) != want:
            raise ValueError(f"{name} has shape {tuple(ten.shape)}, "
                             f"expected {want}")
    for name, ten in v.items():
        if ten.numel() != c:
            raise ValueError(f"{name} must hold C={c} values")
    if x.device.type == "cuda":
        if c not in KERNEL_CHANNELS:
            raise ValueError(f"the CUDA kernels take C in {KERNEL_CHANNELS},"
                             f" got {c}")
        if k > MAX_TAPS:
            raise ValueError(f"the CUDA kernels take at most {MAX_TAPS} "
                             f"taps, got {k}")
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")


def _split(red, *sizes):
    out, at = [], 0
    for size in sizes:
        out.append(red[at:at + size])
        at += size
    return out


def pass_f1(x, dw_w, v, dilation):
    """F1: bn0 sums (Σu, Σu²) of u = dwconv(x).  v: dw_b."""
    _check(x, {"x": x, "dw": dw_w}, v, dw_w.shape[0])
    if x.device.type == "cpu":
        return _f1_plain(x, dw_w, v, dilation)
    c = x.shape[2]
    out = _launch("f1", x, {"x": x, "dw": dw_w}, v, dilation, 0.0,
                  dw_w.shape[0])
    return tuple(_split(out["reduced"], c, c))


def pass_f2(x, dw_w, w1, v, dilation):
    """F2: bn1 sums of v = bn0(u) @ W1 + b1.  v: dw_b, a0, c0, b1."""
    _check(x, {"x": x, "dw": dw_w, "pw1": w1}, v, dw_w.shape[0])
    if x.device.type == "cpu":
        return _f2_plain(x, dw_w, w1, v, dilation)
    c = x.shape[2]
    out = _launch("f2", x, {"x": x, "dw": dw_w, "pw1": w1}, v, dilation,
                  0.0, dw_w.shape[0])
    return tuple(_split(out["reduced"], c, c))


def pass_f3(x, dw_w, w1, w2, v, dilation):
    """F3: r = relu(bn1(v)), w = r @ W2 + b2, and bn2 sums of w.
    v: dw_b, a0, c0, b1, a1, c1, b2."""
    _check(x, {"x": x, "dw": dw_w, "pw1": w1, "pw2": w2}, v, dw_w.shape[0])
    if x.device.type == "cpu":
        return _f3_plain(x, dw_w, w1, w2, v, dilation)
    c = x.shape[2]
    out = _launch("f3", x, {"x": x, "dw": dw_w, "pw1": w1, "pw2": w2}, v,
                  dilation, 0.0, dw_w.shape[0])
    return (out["out_r"], out["out_w"]) + tuple(_split(out["reduced"], c, c))


def pass_f4(w, x, v):
    """F4: y = relu(a2 * w + c2 + x).  v: a2, c2."""
    _check(x, {"x": x, "w": w}, v, 1)
    if x.device.type == "cpu":
        return _f4_plain(w, x, v)
    return _launch("f4", x, {"x": x, "w": w}, v, 1, 0.0, 1)["out_y"]


def pass_b1(dy, w, x, v):
    """B1: bn2 gradient sums (Σg2, Σg2·ŵ).  v: a2, c2, mu2, inv2."""
    _check(x, {"x": x, "dy": dy, "w": w}, v, 1)
    if x.device.type == "cpu":
        return _b1_plain(dy, w, x, v)
    c = x.shape[2]
    out = _launch("b1", x, {"x": x, "dy": dy, "w": w}, v, 1, 0.0, 1)
    return tuple(_split(out["reduced"], c, c))


def pass_b2(dy, w, x, r, w2, v, n):
    """B2: dW2, db2 and the bn1 gradient sums (Σds1, Σds1·v̂).
    v: a2, c2, mu2, inv2, coef2, sg, sgw, beta1, gamma1."""
    mats = {"x": x, "dy": dy, "w": w, "r": r, "pw2": w2}
    _check(x, mats, v, 1)
    if x.device.type == "cpu":
        return _b2_plain(dy, w, x, r, w2, v, n)
    c = x.shape[2]
    red = _launch("b2", x, mats, v, 1, n, 1)["reduced"]
    dw2, db2, sds1, sds1v = _split(red, c * c, c, c, c)
    return dw2.view(c, c), db2, sds1, sds1v


def pass_b3(dy, w, x, r, dw_w, w1, w2, v, dilation, n):
    """B3: dW1, db1, the bn0 gradient sums (Σds0, Σds0·û) and ds0
    (B, T, C) itself, which B4 reads.  v: B2's plus dw_b, a0, c0, mu0,
    inv0, b1, mu1, inv1, coef1, sds1, sds1v."""
    mats = {"x": x, "dy": dy, "w": w, "r": r, "dw": dw_w, "pw1": w1,
            "pw2": w2}
    _check(x, mats, v, dw_w.shape[0])
    if x.device.type == "cpu":
        return _b3_plain(dy, w, x, r, dw_w, w1, w2, v, dilation, n)
    c = x.shape[2]
    out = _launch("b3", x, mats, v, dilation, n, dw_w.shape[0])
    dw1, db1, sds0, sds0u = _split(out["reduced"], c * c, c, c, c)
    return dw1.view(c, c), db1, sds0, sds0u, out["ds0"]


def pass_b4(dy, w, x, ds0, dw_w, v, dilation, n):
    """B4: dx, dWd (K, C), dbd from B3's ds0; no C x C product.
    v: a2, c2, dw_b, mu0, inv0, coef0, sds0, sds0u."""
    mats = {"x": x, "dy": dy, "w": w, "ds0": ds0, "dw": dw_w}
    k = dw_w.shape[0]
    _check(x, mats, v, k)
    if x.device.type == "cpu":
        return _b4_plain(dy, w, x, ds0, dw_w, v, dilation, n)
    c = x.shape[2]
    out = _launch("b4", x, mats, v, dilation, n, k)
    dwd, dbd = _split(out["reduced"], k * c, c)
    return out["dx"], dwd.view(k, c), dbd


PASSES = {"f1": pass_f1, "f2": pass_f2, "f3": pass_f3, "f4": pass_f4,
          "b1": pass_b1, "b2": pass_b2, "b3": pass_b3, "b4": pass_b4}
for _fn, _plain in zip(PASSES.values(), (
        _f1_plain, _f2_plain, _f3_plain, _f4_plain, _b1_plain, _b2_plain,
        _b3_plain, _b4_plain)):
    _fn.plain = _plain
    _fn.launches = 0


def reset_launches() -> None:
    for fn in PASSES.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# the block: eight passes under one autograd Function
# ---------------------------------------------------------------------------


def _stat(s, ss, n, eps):
    mu = s / n
    var = torch.clamp(ss / n - mu * mu, min=0.0)
    return mu, var, torch.rsqrt(var + eps)


def _run_public(name, *args):
    return PASSES[name](*args)


def block_forward(x, p, dilation, eps, run=_run_public):
    """F1..F4.  ``p``: PARAM_KEYS, with dw_kernel as (K, C) and the
    pointwise kernels as (in, out), all contiguous float32.  Returns
    (y, r, w, v) with v the per-channel values the backward needs.
    ``run(name, *args)`` runs one pass (the public pass by default)."""
    b, t, _ = x.shape
    n = float(b * t)
    dw_w = p["dw_kernel"]
    v = {"dw_b": p["dw_bias"]}
    su, suu = run("f1", x, dw_w, v, dilation)
    v["mu0"], v["var0"], v["inv0"] = _stat(su, suu, n, eps)
    v["a0"] = p["bn0_scale"] * v["inv0"]
    v["c0"] = p["bn0_bias"] - p["bn0_scale"] * v["inv0"] * v["mu0"]
    v["b1"] = p["pw1_bias"]
    sv, svv = run("f2", x, dw_w, p["pw1_kernel"], _only(v, "f2"), dilation)
    v["mu1"], v["var1"], v["inv1"] = _stat(sv, svv, n, eps)
    v["a1"] = p["bn1_scale"] * v["inv1"]
    v["c1"] = p["bn1_bias"] - p["bn1_scale"] * v["inv1"] * v["mu1"]
    v["b2"] = p["pw2_bias"]
    r, w, sw, sww = run("f3", x, dw_w, p["pw1_kernel"], p["pw2_kernel"],
                        _only(v, "f3"), dilation)
    v["mu2"], v["var2"], v["inv2"] = _stat(sw, sww, n, eps)
    v["a2"] = p["bn2_scale"] * v["inv2"]
    v["c2"] = p["bn2_bias"] - p["bn2_scale"] * v["inv2"] * v["mu2"]
    y = run("f4", w, x, _only(v, "f4"))
    return y, r, w, v


def block_backward(dy, x, r, w, p, v, dilation, run=_run_public):
    """B1..B4.  Returns (dx, grads by PARAM_KEYS in the layouts of
    ``block_forward``)."""
    b, t, _ = x.shape
    n = float(b * t)
    dw_w, w1, w2 = p["dw_kernel"], p["pw1_kernel"], p["pw2_kernel"]
    v = dict(v)
    v["coef2"] = p["bn2_scale"] * v["inv2"]
    v["coef1"] = p["bn1_scale"] * v["inv1"]
    v["coef0"] = p["bn0_scale"] * v["inv0"]
    v["beta1"], v["gamma1"] = p["bn1_bias"], p["bn1_scale"]
    v["sg"], v["sgw"] = run("b1", dy, w, x, _only(v, "b1"))
    dw2, db2, v["sds1"], v["sds1v"] = run("b2", dy, w, x, r, w2,
                                          _only(v, "b2"), n)
    dw1, db1, v["sds0"], v["sds0u"], ds0 = run(
        "b3", dy, w, x, r, dw_w, w1, w2, _only(v, "b3"), dilation, n)
    dx, dwd, dbd = run("b4", dy, w, x, ds0, dw_w, _only(v, "b4"), dilation,
                       n)
    grads = {
        "dw_kernel": dwd, "dw_bias": dbd,
        "pw1_kernel": dw1, "pw1_bias": db1,
        "pw2_kernel": dw2, "pw2_bias": db2,
        "bn2_scale": v["sgw"], "bn2_bias": v["sg"],
        "bn1_scale": v["sds1v"], "bn1_bias": v["sds1"],
        "bn0_scale": v["sds0u"], "bn0_bias": v["sds0"],
    }
    return dx, grads


# per-channel values each pass reads (the rest of the packed vector is
# zero); the plain versions read the same names
_PASS_VALUES = {
    "f2": ("dw_b", "a0", "c0", "b1"),
    "f3": ("dw_b", "a0", "c0", "b1", "a1", "c1", "b2"),
    "f4": ("a2", "c2"),
    "b1": ("a2", "c2", "mu2", "inv2"),
    "b2": ("a2", "c2", "mu2", "inv2", "coef2", "sg", "sgw", "beta1",
           "gamma1"),
}
_PASS_VALUES["b3"] = _PASS_VALUES["b2"] + (
    "dw_b", "a0", "c0", "mu0", "inv0", "b1", "mu1", "inv1", "coef1",
    "sds1", "sds1v")
_PASS_VALUES["b4"] = ("a2", "c2", "dw_b", "mu0", "inv0", "coef0", "sds0",
                      "sds0u")


def _only(v, name):
    return {k: v[k].contiguous() for k in _PASS_VALUES[name]}


def _kernel_layout(params):
    """JAX-layout params -> the passes' layouts, contiguous."""
    p = {k: params[k] for k in PARAM_KEYS}
    p["dw_kernel"] = p["dw_kernel"][:, 0, :]
    return {k: t.contiguous() for k, t in p.items()}


class FusedTCNBlockTrain(torch.autograd.Function):
    """y, mu0, var0, mu1, var1, mu2, var2 = apply(x, dilation, eps,
    *params in PARAM_KEYS order, JAX layouts).  The statistics carry no
    gradient (running-average updates are stop-gradient, as in flax)."""

    @staticmethod
    def forward(ctx, x, dilation, eps, *params):
        p = _kernel_layout(dict(zip(PARAM_KEYS, params)))
        x = x.contiguous()
        y, r, w, v = block_forward(x, p, dilation, eps)
        keep = ("dw_b", "a0", "c0", "mu0", "inv0", "b1", "mu1", "inv1",
                "b2", "a2", "c2", "mu2", "inv2")
        ctx.dilation = dilation
        ctx.keep = keep
        ctx.save_for_backward(x, r, w, *[p[k] for k in PARAM_KEYS],
                              *[v[k] for k in keep])
        stats = (v["mu0"], v["var0"], v["mu1"], v["var1"], v["mu2"],
                 v["var2"])
        ctx.mark_non_differentiable(*stats)
        return (y,) + stats

    @staticmethod
    def backward(ctx, dy, *unused):
        saved = ctx.saved_tensors
        x, r, w = saved[:3]
        nk = len(PARAM_KEYS)
        p = dict(zip(PARAM_KEYS, saved[3:3 + nk]))
        v = dict(zip(ctx.keep, saved[3 + nk:]))
        dx, grads = block_backward(dy.contiguous(), x, r, w, p, v,
                                   ctx.dilation)
        g = dict(grads)
        g["dw_kernel"] = g["dw_kernel"][:, None, :]
        return (dx, None, None) + tuple(g[k] for k in PARAM_KEYS)


def fused_tcn_block_train(
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    kernel_size: int,
    dilation: int,
    eps: float = 1e-5,
    precision: str = "float32",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fused training forward of one TCNBlock with exact batch-stats BN.

    ``params`` carries the JAX package's keys and layouts: dw_kernel
    (K, 1, C), dw_bias (C,), pw1_kernel / pw2_kernel (C, C) as
    (in, out), pw*_bias, bn{0,1,2}_{scale,bias}.  Returns ``(y,
    stats)`` with stats {mu0, var0, mu1, var1, mu2, var2} (C,) for the
    caller's running-average updates.  The residual needs
    in_channels == res_channels.  Gradients flow to ``x`` and every
    parameter through autograd."""
    if precision != "float32":
        raise NotImplementedError(
            f"precision={precision!r}: only float32 is ported (ROADMAP "
            "queue A, item 15, training knobs)")
    if tuple(params["dw_kernel"].shape)[0] != kernel_size:
        raise ValueError(f"dw_kernel has {params['dw_kernel'].shape[0]} "
                         f"taps, kernel_size is {kernel_size}")
    out = FusedTCNBlockTrain.apply(x, int(dilation), float(eps),
                                   *[params[k] for k in PARAM_KEYS])
    y, stats = out[0], out[1:]
    return y, dict(zip(("mu0", "var0", "mu1", "var1", "mu2", "var2"),
                       stats))


def trace_pass_inputs(x, params, dy, dilation, eps=1e-5):
    """Run one block forward and backward through the PLAIN passes and
    return {pass name: its argument tuple}, so that each kernel can be
    held against its plain version on identical inputs.  ``params`` in
    JAX layouts, as for ``fused_tcn_block_train``."""
    calls = {}

    def run(name, *args):
        calls[name] = args
        return PASSES[name].plain(*args)

    p = _kernel_layout(params)
    x = x.contiguous()
    _, r, w, v = block_forward(x, p, dilation, eps, run)
    block_backward(dy.contiguous(), x, r, w, p, v, dilation, run)
    return calls


# ---------------------------------------------------------------------------
# holding a kernel against its plain version
# ---------------------------------------------------------------------------

OUT_TOL = 1e-4  # (B, T, C) outputs, abs and rel: fp32 in another order
SUM_TOL = 1e-3  # sums over frames, relative to the largest of their group


def seeded_block_inputs(gen, b, t, c, k, device):
    """Block parameters in JAX layouts, an input x and an upstream
    gradient dy, drawn from the torch.Generator ``gen``."""
    def r(*shape, scale=0.3):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    p = {"dw_kernel": r(k, 1, c), "dw_bias": r(c),
         "pw1_kernel": r(c, c, scale=c ** -0.5), "pw1_bias": r(c, scale=0.1),
         "pw2_kernel": r(c, c, scale=c ** -0.5), "pw2_bias": r(c, scale=0.1)}
    for i in range(3):
        p[f"bn{i}_scale"] = 1.0 + r(c, scale=0.1)
        p[f"bn{i}_bias"] = r(c, scale=0.1)
    return p, r(b, t, c, scale=1.0), r(b, t, c, scale=1.0)


def compare_sums(name, gots, wants, floor=1.0, tol=SUM_TOL):
    """Largest abs error of a group of sums over frames (BN sums,
    gradients).  Raises AssertionError where one is not finite or is
    off by more than ``tol`` x the largest |value| of ``wants`` (at
    least ``floor``).  One scale for the group, because a sum that
    cancels to about zero (the gradient of a bias that a BatchNorm
    follows) carries the rounding of terms as large as the group's
    other sums."""
    scale = max([float(w.abs().max()) for w in wants] + [floor])
    worst = 0.0
    for i, (got, want) in enumerate(zip(gots, wants)):
        err = float((got - want).abs().max())
        if not err <= tol * scale or not bool(got.isfinite().all()):
            raise AssertionError(f"{name}[{i}]: max abs err {err:.3e} over "
                                 f"the bound {tol} x {scale:.3e}")
        worst = max(worst, err)
    return worst


def compare_pass(name, got, want):
    """Largest abs error of one pass's outputs against its plain
    version's: (B, T, C) outputs within OUT_TOL abs + OUT_TOL rel,
    the pass's sums as one group of ``compare_sums``."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    sums = []
    for i, (a, b) in enumerate(zip(got, want)):
        if b.dim() != 3:
            sums.append((a, b))
            continue
        err = float((a - b).abs().max())
        if not (torch.allclose(a, b, atol=OUT_TOL, rtol=OUT_TOL)
                and bool(a.isfinite().all())):
            raise AssertionError(f"{name}[{i}]: max abs err {err:.3e} over "
                                 f"{OUT_TOL} abs + {OUT_TOL} rel")
        worst = max(worst, err)
    if sums:
        worst = max(worst, compare_sums(name, *zip(*sums)))
    return worst
