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
same inputs, for the tests and ``chip_smoke.py``; inside ``with
plain_passes(...)`` the fused block runs the named passes by their
plain versions, to bisect its numerics by pass.

Gradients are the textbook exact-BN backward per layer composed
through the block; they equal autograd of the unfused block
(``models/mdtc.py``), which the tests pin.  ``fused_tcn_block_train``
is the ``torch.autograd.Function`` around the eight passes.

Under data parallelism (a process group initialised,
``parallel/mesh.py``) the statistics are the global batch's, as
``pallas_call`` takes them over the whole sharded operand: each pair of
sums a pass returns, forward (su, suu), (sv, svv), (sw, sww) and
backward (sg, sgw), (sds1, sds1v), (sds0, sds0u), is packed into one
tensor and all-reduced before it becomes a mean or a coefficient, and
``n`` is the global frame count, the ranks' ``b x t`` summed on the
host once a block (each rank may hold another number of rows), which
the backward reuses.  The backward sums are also the BN parameters'
gradients: those leave the block rank-local, because the trainer
all-reduces every gradient once.  Without a group nothing is reduced
and nothing changes.

``precision="bfloat16"`` (the JAX package's ``mdt = bf16``, chosen there
when the block's ``dtype`` is bfloat16) runs the bf16-operand variants
of F2, F3, B2 and B3 (``BF16_PASSES``): every C x C product takes
operands rounded to bf16 and sums in float32, as ``jnp.dot(a.astype(
bf16), b.astype(bf16), preferred_element_type=float32)``, and F3's ``r``
is stored as bf16, which B2 and B3 read back (so B2's v-hat comes from
the bf16 ``r``).  x, w, dy, ds0, y, dx, every sum and every per-channel
value stay float32; F1, F4, B1 and B4 are the same kernels at both
precisions.  The plain versions round the same operands with
``Tensor.to(torch.bfloat16)`` before a float32 ``matmul``, which is
exact in its products.  A variant counts its launches apart
(``.bf16_launches``) and has its own kernel name (``kernel_name``).
All four bf16 kernels run their products on the tensor cores.  F2's and
F3's are one body on 128-row tiles with one rule for staging their
window of x (``f3_bf16_staged``); B2's cuts 64-row tiles; B3's 32-row
tiles (64 at C=32) with the next tile's rows copied while its
products run, its window of x staged where it fits
(``b3_bf16_staged``).
``bf16_tile_rows`` and ``tile_smem_bytes`` mirror the kernels' launch
plans.
"""

import contextlib
import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from wekws_tpu_torch.ops import cuda_build
from wekws_tpu_torch.parallel.mesh import (
    all_reduce_count,
    all_reduce_sum,
    is_distributed,
)

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
PRECISIONS = ("float32", "bfloat16")
# the passes with a bf16-operand variant: those with a C x C product
BF16_PASSES = ("f2", "f3", "b2", "b3")


def kernel_name(name: str, c: int, precision: str = "float32") -> str:
    """The CUDA kernel of pass ``name`` at C channels and ``precision``,
    as a profiler names it (its block reduction is
    ``reduce_kernel<PASS_IDS[name]>`` at both precisions)."""
    if precision == "bfloat16" and name in BF16_PASSES:
        return f"{name}_bf16_kernel<{c}>"
    return {"f1": f"f1_tile_kernel<{c}>", "f2": f"f2_kernel<{c}>",
            "f3": f"f3_kernel<{c}>", "f4": f"f4_kernel<{c}>",
            "b1": f"b1_stream_kernel<{c}>", "b2": f"b2_kernel<{c}>",
            "b3": f"b3_kernel<{c}>", "b4": f"b4_kernel<{c}>"}[name]


def _bf(z, precision):
    """An operand of a product at ``precision``: rounded to bf16 (and
    kept as float32, where the product of two is exact)."""
    if precision == "bfloat16":
        return z.to(torch.bfloat16).to(z.dtype)
    return z


def _mm(a, b, precision):
    """a @ b with operands at ``precision``, float32 sums."""
    return torch.matmul(_bf(a, precision), _bf(b, precision))


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


def _pw1(x, dw_w, w1, v, dilation, precision="float32"):
    u = _dw(x, dw_w, v["dw_b"], dilation)
    s0 = u * v["a0"] + v["c0"]
    return u, s0, _mm(s0, w1, precision) + v["b1"]


def _f2_plain(x, dw_w, w1, v, dilation, precision="float32"):
    return _sums(_pw1(x, dw_w, w1, v, dilation, precision)[2])


def _f3_plain(x, dw_w, w1, w2, v, dilation, precision="float32"):
    vv = _pw1(x, dw_w, w1, v, dilation, precision)[2]
    r = _bf(torch.relu(vv * v["a1"] + v["c1"]), precision)
    w = _mm(r, w2, precision) + v["b2"]
    if precision == "bfloat16":  # stored as bf16 (exact: r is rounded)
        r = r.to(torch.bfloat16)
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


def _ds1(dy, w, x, r, w2, v, n, precision="float32"):
    g2, what = _g2_what(dy, w, x, v)
    dwg = _bn_back(v["coef2"], g2, v["sg"], v["sgw"], what, n)
    dr = _mm(dwg, w2.t(), precision)
    return dwg, dr * (r > 0.0)


def _rows(z):
    return z.reshape(-1, z.shape[-1])


def _b2_plain(dy, w, x, r, w2, v, n, precision="float32"):
    r = r.float()  # a bf16 r is widened, exactly
    dwg, ds1 = _ds1(dy, w, x, r, w2, v, n, precision)
    dw2 = _mm(_rows(r).t(), _rows(dwg), precision)
    # v-hat where ds1 != 0: there r = s1 = gamma1 * vhat + beta1
    vhat = (r - v["beta1"]) / v["gamma1"]
    return (dw2, dwg.sum(dim=(0, 1)), ds1.sum(dim=(0, 1)),
            (ds1 * vhat).sum(dim=(0, 1)))


def _ds0(dy, w, x, r, dw_w, w1, w2, v, dilation, n, precision="float32"):
    _, ds1 = _ds1(dy, w, x, r.float(), w2, v, n, precision)
    u, s0, vv = _pw1(x, dw_w, w1, v, dilation, precision)
    uhat = (u - v["mu0"]) * v["inv0"]
    vhat = (vv - v["mu1"]) * v["inv1"]
    dv = _bn_back(v["coef1"], ds1, v["sds1"], v["sds1v"], vhat, n)
    return s0, uhat, dv, _mm(dv, w1.t(), precision)


def _b3_plain(dy, w, x, r, dw_w, w1, w2, v, dilation, n,
              precision="float32"):
    s0, uhat, dv, ds0 = _ds0(dy, w, x, r, dw_w, w1, w2, v, dilation, n,
                             precision)
    dw1 = _mm(_rows(s0).t(), _rows(dv), precision)
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
FLAT_PASSES = ("f1", "f2", "f3", "b2", "b3")
# F1 stages two windows of x where they fit (``kF1Staged``), or streams;
# its tiles are F1_ROW_SCALE times F2's rows (``kF1RowScale``)
F1_STAGED = True
F1_ROW_SCALE = 2
B1_ROWS_IN_FLIGHT = 4  # rows of w, x and dy a B1 thread loads at once
# rows of F2's, F3's and B2's tiles at bf16 (``kF3bRows``: 16 rows a
# warp, eight warps; ``kB2bRows``); B3's are ``b3_bf16_rows``
BF16_TILE_ROWS = {"f2": 128, "f3": 128, "b2": 64}


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
    """Rows of an F1, F2, F3, B2 or B3 tile: 64, or 32 at C=128, where F3's
    and B3's weight matrices leave shared memory for no more."""
    return 32 if c == 128 else TILE_ROWS


def bf16_tile_rows(name: str, c: int, precision: str = "float32") -> int:
    """Rows of a pass's tile over the flattened frames at ``precision``:
    F2's, F3's and B2's bf16 kernels have their own (``BF16_TILE_ROWS``),
    B3's ``b3_bf16_rows``, the others ``flat_tile_rows``."""
    if precision == "bfloat16" and name in BF16_TILE_ROWS:
        return BF16_TILE_ROWS[name]
    if precision == "bfloat16" and name == "b3":
        return b3_bf16_rows(c)
    return flat_tile_rows(c)


def b3_bf16_rows(c: int) -> int:
    """Rows of B3's bf16 tile (``b3_bf16_rows``): 32, or 64 at C=32."""
    return 64 if c == 32 else 32


def f1_tile_rows(c: int) -> int:
    """Rows of an F1 tile: F1_ROW_SCALE times ``flat_tile_rows``."""
    return F1_ROW_SCALE * flat_tile_rows(c)


def b1_block_rows(c: int) -> int:
    """Rows a B1 block loads at once: 256 threads, C / 4 of them to a
    row, each holding B1_ROWS_IN_FLIGHT rows (``kB1Rows`` in the
    kernel)."""
    return B1_ROWS_IN_FLIGHT * 1024 // c


def f3_window_bytes(c: int, halo: int) -> int:
    """F2's and F3's staged window of x: a tile's rows and the causal
    halo (K-1) * dilation before them."""
    return 4 * c * (flat_tile_rows(c) + halo)


def _fwd_bf16_base(name: str, c: int) -> int:
    """F2's or F3's bf16 shared memory without the window
    (``fwd_bf16_base_bytes``): the constants and the taps, then W1 (F3:
    and W2) as bf16 at row stride C + 8."""
    mats = 2 if name == "f3" else 1
    return 4 * (len(VEC_KEYS) + MAX_TAPS) * c + mats * 2 * c * (c + 8)


def f3_bf16_staged(c: int, halo: int) -> bool:
    """Whether F2's and F3's bf16 kernels stage their window of x
    (``f3_bf16_staged``, one rule for both): where F3's fits a block
    beside its constants and bf16 weights; else they read the taps from
    device memory."""
    return (_fwd_bf16_base("f3", c)
            + 4 * c * (BF16_TILE_ROWS["f3"] + halo) <= SMEM_LIMIT)


def _b3_bf16_base(c: int) -> int:
    """B3's bf16 shared memory without its window
    (``b3_bf16_base_bytes``): the constants and the taps, a tile's staged
    w and dy rows (float32), then W1, W2, the dwg (then dv), s0 and r
    tiles as bf16 at row stride C + 8."""
    rows = b3_bf16_rows(c)
    return (4 * ((len(VEC_KEYS) + MAX_TAPS) * c + 2 * rows * c)
            + 2 * (2 * c + 3 * rows) * (c + 8))


def _b3_bf16_window(c: int, halo: int) -> int:
    """B3's bf16 window of x (``b3_bf16_window_bytes``): a tile's rows
    and the causal halo before them."""
    return 4 * c * (b3_bf16_rows(c) + halo)


def b3_bf16_staged(c: int, halo: int) -> bool:
    """Whether B3's bf16 kernel stages its window of x
    (``b3_bf16_staged``): where it fits a block beside the rest; else it
    reads x and its taps from device memory."""
    return _b3_bf16_base(c) + _b3_bf16_window(c, halo) <= SMEM_LIMIT


def tile_smem_bytes(name: str, c: int, halo: int = 0,
                    precision: str = "float32") -> int:
    """Shared memory of one F1, F2, F3, B2 or B3 block
    (csrc/fused_mdtc_train.cu ``fwd_smem_bytes``, ``b2_smem_bytes``,
    ``b3_smem_bytes``, and at bf16 ``fwd_bf16_base_bytes`` with its
    window, ``b2_bf16_smem_bytes``, ``b3_bf16_base_bytes`` with its
    window): the packed
    per-channel vector (with the taps, but in B2), the C x C weight
    matrices and the tiles, at row stride C + 4 (F1: no matrix, one tile
    for its reduction); B2 adds the next tile's w, x and dy rows, staged;
    F2 and F3 their window of x (``f3_window_bytes``) where F3's fits a
    block (``run`` there decides the same), else they read the taps from
    device memory; F1 two windows where they fit beside its own
    (``F1_STAGED``).  At bf16 F2 holds W1 and F3 W1 and W2 as bf16 at
    row stride C + 8, both the window of their 128-row tile where F3's
    fits (``f3_bf16_staged``); B2 its staged w, x and dy rows (fp32),
    then W2, the dwg tile and two r tiles as bf16 at row stride C + 8;
    B3 its staged w and dy rows (fp32), then W1, W2 and its dwg (then
    dv), s0 and r tiles as bf16 at row stride C + 8, and its window of x
    where it fits (``b3_bf16_staged``)."""
    if precision == "bfloat16" and name == "b3":
        return _b3_bf16_base(c) + (
            _b3_bf16_window(c, halo) if b3_bf16_staged(c, halo) else 0)
    if precision == "bfloat16" and name in ("f2", "f3"):
        window = 4 * c * (BF16_TILE_ROWS["f3"] + halo)
        return (_fwd_bf16_base(name, c)
                + (window if f3_bf16_staged(c, halo) else 0))
    if precision == "bfloat16" and name == "b2":
        rows = BF16_TILE_ROWS["b2"]
        return 4 * (len(VEC_KEYS) + 3 * rows) * c + 2 * (c + 3 * rows) * (c + 8)

    def unstaged(name):
        vec, mats, tiles = {
            "f1": (len(VEC_KEYS) + MAX_TAPS, 0, 1),
            "f2": (len(VEC_KEYS) + MAX_TAPS, 1, 1),
            "f3": (len(VEC_KEYS) + MAX_TAPS, 2, 2),
            "b2": (len(VEC_KEYS), 1, 2),
            "b3": (len(VEC_KEYS) + MAX_TAPS, 2, 4),
        }[name]
        ld = c + 4
        return 4 * (vec * c + mats * c * ld + tiles * flat_tile_rows(c) * ld)

    smem = unstaged(name)
    if name == "b2":  # the next tile's w, x and dy rows, staged
        smem += 4 * 3 * flat_tile_rows(c) * c
    window = f3_window_bytes(c, halo)
    if name == "f1":
        windows = 2 * 4 * c * (f1_tile_rows(c) + halo)
        if F1_STAGED and smem + windows <= SMEM_LIMIT:
            smem += windows
        return smem
    if name in ("f2", "f3") and unstaged("f3") + window <= SMEM_LIMIT:
        smem += window
    return smem


def blocks_per_sm(smem: int, c: int) -> int:
    """Blocks of an F1, F2, F3, B2 or B3 launch that one SM holds at once:
    as many as its shared memory allows, at most the blocks that their
    ``__launch_bounds__`` plan registers for (two at C <= 64, one at
    C=128)."""
    return min(1 if c == 128 else 2, SM_SMEM // (smem + 1024))


def _tiles(name: str, b: int, t: int, c: int, rows: int,
           precision: str = "float32") -> int:
    """Work units of one pass: F1, F2, F3, B2 and B3 tile the
    flattened B x T frames (``bf16_tile_rows`` at ``precision``) and B1
    streams them (``b1_block_rows`` at a time), B4 cuts each utterance
    into ``rows``-frame tiles; F4 is elementwise (no tiles)."""
    if name == "f1":
        return _cdiv(b * t, f1_tile_rows(c))
    if name in FLAT_PASSES:
        return _cdiv(b * t, bf16_tile_rows(name, c, precision))
    if name == "b1":
        return _cdiv(b * t, b1_block_rows(c))
    if name == "b4":
        return b * _cdiv(t, rows)
    return 0


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


def _launch(name, x, tensors, v, dilation, n, k, precision="float32"):
    """One pass on x's device and current stream.  ``tensors`` holds the
    (B, T, C) inputs and weights by slot name; returns the outputs."""
    lib, fn = _kernel_fn()
    b, t, c = x.shape
    dev = x.device
    bf16 = precision == "bfloat16"
    width = _partial_width(name, c, k)
    rows = (b4_tile_rows(t, c, (k - 1) * int(dilation)) if name == "b4"
            else TILE_ROWS)
    per_sm = 2
    if name in FLAT_PASSES:
        smem = tile_smem_bytes(name, c, (k - 1) * int(dilation), precision)
        per_sm = blocks_per_sm(smem, c)
    nblocks = _grid_blocks(dev, _tiles(name, b, t, c, rows, precision),
                           per_sm)
    ptrs = dict(tensors)
    ptrs["vec"] = _pack(v, c, dev)
    out = {}
    if name == "f3":
        out["out_r"] = torch.empty_like(
            x, dtype=torch.bfloat16 if bf16 else torch.float32)
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
    dims = (ctypes.c_int * 8)(c, b, t, k, int(dilation), nblocks, rows,
                              int(bf16))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(PASS_IDS[name], arr, dims, float(n), stream)
    if err != 0:
        msg = lib.fused_train_error_string(err).decode()
        raise RuntimeError(f"fused_mdtc_train {name} kernel launch failed: "
                           f"{msg} ({err})")
    if bf16:
        PASSES[name].bf16_launches += 1
    else:
        PASSES[name].launches += 1
    return out


def _check(x, mats, v, k, precision="float32"):
    """Inputs of one pass: float32 (``r`` bf16 at bf16), contiguous, on
    x's device, at a precision the pass has."""
    if x.dim() != 3:
        raise ValueError(f"activations must be (B, T, C), got "
                         f"{tuple(x.shape)}")
    b, t, c = x.shape
    if b < 1 or t < 1:
        raise ValueError("empty batch or utterance")
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of "
                         f"{PRECISIONS}")
    for name, ten in list(mats.items()) + list(v.items()):
        if not isinstance(ten, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor")
        if ten.device != x.device:
            raise ValueError(f"{name} is on {ten.device}, expected "
                             f"{x.device}")
        want = (torch.bfloat16 if name == "r" and precision == "bfloat16"
                else torch.float32)
        if ten.dtype != want:
            raise TypeError(f"{name} has dtype {ten.dtype}, expected "
                            f"{want} at precision {precision}")
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


def pass_f2(x, dw_w, w1, v, dilation, precision="float32"):
    """F2: bn1 sums of v = bn0(u) @ W1 + b1.  v: dw_b, a0, c0, b1."""
    _check(x, {"x": x, "dw": dw_w, "pw1": w1}, v, dw_w.shape[0], precision)
    if x.device.type == "cpu":
        return _f2_plain(x, dw_w, w1, v, dilation, precision)
    c = x.shape[2]
    out = _launch("f2", x, {"x": x, "dw": dw_w, "pw1": w1}, v, dilation,
                  0.0, dw_w.shape[0], precision)
    return tuple(_split(out["reduced"], c, c))


def pass_f3(x, dw_w, w1, w2, v, dilation, precision="float32"):
    """F3: r = relu(bn1(v)), w = r @ W2 + b2, and bn2 sums of w (r bf16
    at bf16).  v: dw_b, a0, c0, b1, a1, c1, b2."""
    _check(x, {"x": x, "dw": dw_w, "pw1": w1, "pw2": w2}, v, dw_w.shape[0],
           precision)
    if x.device.type == "cpu":
        return _f3_plain(x, dw_w, w1, w2, v, dilation, precision)
    c = x.shape[2]
    out = _launch("f3", x, {"x": x, "dw": dw_w, "pw1": w1, "pw2": w2}, v,
                  dilation, 0.0, dw_w.shape[0], precision)
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


def pass_b2(dy, w, x, r, w2, v, n, precision="float32"):
    """B2: dW2, db2 and the bn1 gradient sums (Σds1, Σds1·v̂).
    v: a2, c2, mu2, inv2, coef2, sg, sgw, beta1, gamma1."""
    mats = {"x": x, "dy": dy, "w": w, "r": r, "pw2": w2}
    _check(x, mats, v, 1, precision)
    if x.device.type == "cpu":
        return _b2_plain(dy, w, x, r, w2, v, n, precision)
    c = x.shape[2]
    red = _launch("b2", x, mats, v, 1, n, 1, precision)["reduced"]
    dw2, db2, sds1, sds1v = _split(red, c * c, c, c, c)
    return dw2.view(c, c), db2, sds1, sds1v


def pass_b3(dy, w, x, r, dw_w, w1, w2, v, dilation, n, precision="float32"):
    """B3: dW1, db1, the bn0 gradient sums (Σds0, Σds0·û) and ds0
    (B, T, C) itself, which B4 reads.  v: B2's plus dw_b, a0, c0, mu0,
    inv0, b1, mu1, inv1, coef1, sds1, sds1v."""
    mats = {"x": x, "dy": dy, "w": w, "r": r, "dw": dw_w, "pw1": w1,
            "pw2": w2}
    _check(x, mats, v, dw_w.shape[0], precision)
    if x.device.type == "cpu":
        return _b3_plain(dy, w, x, r, dw_w, w1, w2, v, dilation, n,
                         precision)
    c = x.shape[2]
    out = _launch("b3", x, mats, v, dilation, n, dw_w.shape[0], precision)
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
    _fn.bf16_launches = 0


def reset_launches() -> None:
    for fn in PASSES.values():
        fn.launches = 0
        fn.bf16_launches = 0


# ---------------------------------------------------------------------------
# the block: eight passes under one autograd Function
# ---------------------------------------------------------------------------


def _summed(s, ss):
    """The pair of per-channel sums over every rank's rows: one
    all-reduce of the two packed; the same tensors without a group."""
    if not is_distributed():
        return s, ss
    both = all_reduce_sum(torch.stack([s, ss]))
    return both[0], both[1]


def _frames(b, t):
    """The global batch's frame count: this rank's b x t summed over
    every rank's (a host collective, no wait on the card)."""
    if not is_distributed():
        return float(b * t)
    return float(all_reduce_count(b * t))


def _stat(s, ss, n, eps):
    mu = s / n
    var = torch.clamp(ss / n - mu * mu, min=0.0)
    return mu, var, torch.rsqrt(var + eps)


def _run_public(name, *args):
    return PASSES[name](*args)


_block_run = _run_public  # how FusedTCNBlockTrain runs a pass


@contextlib.contextmanager
def plain_passes(*names):
    """Inside the ``with``, ``FusedTCNBlockTrain`` runs the passes
    ``names`` by their plain versions (on any device) and the others by
    their kernels: a bisection of the fused block's numerics by pass.
    Outside it every pass launches its kernel."""
    global _block_run

    def run(name, *args):
        fn = PASSES[name]
        return fn.plain(*args) if name in names else fn(*args)

    before, _block_run = _block_run, run
    try:
        yield
    finally:
        _block_run = before


def _at(precision):
    """The trailing precision argument of a pass call: none at float32,
    so that a float32 call's arguments are what they always were."""
    return () if precision == "float32" else (precision,)


def block_forward(x, p, dilation, eps, run=_run_public,
                  precision="float32"):
    """F1..F4.  ``p``: PARAM_KEYS, with dw_kernel as (K, C) and the
    pointwise kernels as (in, out), all contiguous float32.  Returns
    (y, r, w, v) with v the per-channel values the backward needs and
    ``v["n"]`` the global frame count (r bf16 at bf16).
    ``run(name, *args)`` runs one pass (the public pass by default)."""
    b, t, _ = x.shape
    n = _frames(b, t)
    dw_w = p["dw_kernel"]
    v = {"dw_b": p["dw_bias"]}
    su, suu = _summed(*run("f1", x, dw_w, _only(v, "f1"), dilation))
    v["mu0"], v["var0"], v["inv0"] = _stat(su, suu, n, eps)
    v["a0"] = p["bn0_scale"] * v["inv0"]
    v["c0"] = p["bn0_bias"] - p["bn0_scale"] * v["inv0"] * v["mu0"]
    v["b1"] = p["pw1_bias"]
    sv, svv = _summed(*run("f2", x, dw_w, p["pw1_kernel"], _only(v, "f2"),
                           dilation, *_at(precision)))
    v["mu1"], v["var1"], v["inv1"] = _stat(sv, svv, n, eps)
    v["a1"] = p["bn1_scale"] * v["inv1"]
    v["c1"] = p["bn1_bias"] - p["bn1_scale"] * v["inv1"] * v["mu1"]
    v["b2"] = p["pw2_bias"]
    r, w, sw, sww = run("f3", x, dw_w, p["pw1_kernel"], p["pw2_kernel"],
                        _only(v, "f3"), dilation, *_at(precision))
    sw, sww = _summed(sw, sww)
    v["mu2"], v["var2"], v["inv2"] = _stat(sw, sww, n, eps)
    v["a2"] = p["bn2_scale"] * v["inv2"]
    v["c2"] = p["bn2_bias"] - p["bn2_scale"] * v["inv2"] * v["mu2"]
    y = run("f4", w, x, _only(v, "f4"))
    v["n"] = n
    return y, r, w, v


def block_backward(dy, x, r, w, p, v, dilation, run=_run_public,
                   precision="float32"):
    """B1..B4.  Returns (dx, grads by PARAM_KEYS in the layouts of
    ``block_forward``).  The BN-backward sums that B2, B3 and B4 read
    are the global batch's; the BN parameters' gradients are this
    rank's (the same sums before the reduction)."""
    n = v["n"]
    dw_w, w1, w2 = p["dw_kernel"], p["pw1_kernel"], p["pw2_kernel"]
    v = dict(v)
    v["coef2"] = p["bn2_scale"] * v["inv2"]
    v["coef1"] = p["bn1_scale"] * v["inv1"]
    v["coef0"] = p["bn0_scale"] * v["inv0"]
    v["beta1"], v["gamma1"] = p["bn1_bias"], p["bn1_scale"]
    sg, sgw = run("b1", dy, w, x, _only(v, "b1"))
    v["sg"], v["sgw"] = _summed(sg, sgw)
    dw2, db2, sds1, sds1v = run("b2", dy, w, x, r, w2, _only(v, "b2"), n,
                                *_at(precision))
    v["sds1"], v["sds1v"] = _summed(sds1, sds1v)
    dw1, db1, sds0, sds0u, ds0 = run(
        "b3", dy, w, x, r, dw_w, w1, w2, _only(v, "b3"), dilation, n,
        *_at(precision))
    v["sds0"], v["sds0u"] = _summed(sds0, sds0u)
    dx, dwd, dbd = run("b4", dy, w, x, ds0, dw_w, _only(v, "b4"), dilation,
                       n)
    grads = {
        "dw_kernel": dwd, "dw_bias": dbd,
        "pw1_kernel": dw1, "pw1_bias": db1,
        "pw2_kernel": dw2, "pw2_bias": db2,
        "bn2_scale": sgw, "bn2_bias": sg,
        "bn1_scale": sds1v, "bn1_bias": sds1,
        "bn0_scale": sds0u, "bn0_bias": sds0,
    }
    return dx, grads


# per-channel values each pass reads (the rest of the packed vector is
# zero); the plain versions read the same names
_PASS_VALUES = {
    "f1": ("dw_b",),
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
    precision, *params in PARAM_KEYS order, JAX layouts).  The
    statistics carry no gradient (running-average updates are
    stop-gradient, as in flax)."""

    @staticmethod
    def forward(ctx, x, dilation, eps, precision, *params):
        p = _kernel_layout(dict(zip(PARAM_KEYS, params)))
        x = x.contiguous()
        y, r, w, v = block_forward(x, p, dilation, eps, _block_run,
                                   precision)
        keep = ("dw_b", "a0", "c0", "mu0", "inv0", "b1", "mu1", "inv1",
                "b2", "a2", "c2", "mu2", "inv2")
        ctx.dilation, ctx.n = dilation, v["n"]
        ctx.keep, ctx.precision = keep, precision
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
        v = dict(zip(ctx.keep, saved[3 + nk:]), n=ctx.n)
        dx, grads = block_backward(dy.contiguous(), x, r, w, p, v,
                                   ctx.dilation, _block_run, ctx.precision)
        g = dict(grads)
        g["dw_kernel"] = g["dw_kernel"][:, None, :]
        return (dx, None, None, None) + tuple(g[k] for k in PARAM_KEYS)


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
    parameter through autograd.  ``precision="bfloat16"`` runs the
    bf16-operand variants of F2, F3, B2 and B3 (the module docstring);
    y and every gradient stay float32."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of "
                         f"{PRECISIONS}")
    if tuple(params["dw_kernel"].shape)[0] != kernel_size:
        raise ValueError(f"dw_kernel has {params['dw_kernel'].shape[0]} "
                         f"taps, kernel_size is {kernel_size}")
    out = FusedTCNBlockTrain.apply(x, int(dilation), float(eps), precision,
                                   *[params[k] for k in PARAM_KEYS])
    y, stats = out[0], out[1:]
    return y, dict(zip(("mu0", "var0", "mu1", "var1", "mu2", "var2"),
                       stats))


def trace_pass_inputs(x, params, dy, dilation, eps=1e-5,
                      precision="float32"):
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
    _, r, w, v = block_forward(x, p, dilation, eps, run, precision)
    block_backward(dy.contiguous(), x, r, w, p, v, dilation, run, precision)
    return calls


# ---------------------------------------------------------------------------
# holding a kernel against its plain version
# ---------------------------------------------------------------------------

OUT_TOL = 1e-4  # (B, T, C) outputs, abs and rel: fp32 in another order
SUM_TOL = 1e-3  # sums over frames, relative to the largest of their group
# The bf16 variants round the same operands as their plain versions, but
# where the two sides' float32 values (summed in another order) straddle
# a bf16 rounding point, an operand differs by one bf16 step (2^-8 of
# it), and so does each product that reads it: a whole row of C
# outputs.  Such ties hit some 1e-4 of the operands at most; so a (B, T,
# C) output of a bf16 variant may differ beyond OUT_TOL at BF16_OFF_SHARE
# of its elements, and nowhere by more than BF16_OUT_TOL of its largest
# |value|.  Without the rounding (fp32 operands), nearly every element
# would be off.  Its sums over frames move only by summation order and
# by the ties in a rounded operand, most in B2's and B3's, whose BN
# backward cancels before it rounds.  On the H100 the variants' sums
# read up to 1.3e-5 (F2, F3) and 3.2e-4 (B2, B3, at B=3) of their
# group's largest, the float32-operand plain versions on the same
# inputs 6.8e-4 (F3) and 1.7e-3 (B2) at least, so each pass's
# BF16_SUM_TOL lies between.
BF16_OUT_TOL = 2.0 ** -7
BF16_OFF_SHARE = 2e-2
BF16_SUM_TOL = {"f2": 1e-4, "f3": 1e-4, "b2": 8e-4, "b3": 8e-4}


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


def off_share(got, want):
    """Share of the elements of a (B, T, C) output outside OUT_TOL abs
    + OUT_TOL rel of the plain version's."""
    return float((~torch.isclose(got.float(), want.float(), atol=OUT_TOL,
                                 rtol=OUT_TOL)).float().mean())


def compare_pass(name, got, want, precision="float32", sum_tol=SUM_TOL):
    """Largest abs error of one pass's outputs against its plain
    version's: (B, T, C) outputs within OUT_TOL abs + OUT_TOL rel (at
    bf16: BF16_OFF_SHARE of them may lie outside, none beyond
    BF16_OUT_TOL of the output's largest |value|), the pass's sums as
    one group of ``compare_sums`` within ``sum_tol`` (a bf16 variant's
    caller passes its BF16_SUM_TOL)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    sums = []
    for i, (a, b) in enumerate(zip(got, want)):
        if b.dim() != 3:
            sums.append((a, b))
            continue
        if a.dtype != b.dtype:
            raise AssertionError(f"{name}[{i}]: dtype {a.dtype}, the plain "
                                 f"version's {b.dtype}")
        a, b = a.float(), b.float()
        err = float((a - b).abs().max())
        if not bool(a.isfinite().all()):
            raise AssertionError(f"{name}[{i}]: not finite")
        if precision == "bfloat16":
            scale = max(float(b.abs().max()), 1e-30)
            share = off_share(a, b)
            if err > BF16_OUT_TOL * scale or share > BF16_OFF_SHARE:
                raise AssertionError(
                    f"{name}[{i}]: max abs err {err:.3e} ({err / scale:.2e} "
                    f"of its largest |value|, bound {BF16_OUT_TOL}), "
                    f"{share:.2e} of the elements outside {OUT_TOL} abs + "
                    f"{OUT_TOL} rel (bound {BF16_OFF_SHARE})")
        elif not torch.allclose(a, b, atol=OUT_TOL, rtol=OUT_TOL):
            raise AssertionError(f"{name}[{i}]: max abs err {err:.3e} over "
                                 f"{OUT_TOL} abs + {OUT_TOL} rel")
        worst = max(worst, err)
    if sums:
        worst = max(worst, compare_sums(name, *zip(*sums), tol=sum_tol))
    return worst
