"""The port's fused training block (wekws_tpu_torch.ops.fused_mdtc_train)
and its training-mode layers against the JAX package on the CPU.

JAX's ``fused_tcn_block_train`` runs its Pallas kernels in interpret
mode here, as tests/test_fused_train.py runs it; the port runs the
plain versions of its eight passes (the same decomposition its CUDA
kernels implement).  Bounds: float32 on both sides with other
summation orders, so outputs and statistics within 1e-4 and
gradients within 1e-4 of max(1, max |grad|) -- far inside the 2e-2 /
5e-2 that tests/test_fused_train.py pins for the JAX kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fused_train import ref_block
from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.models.layers import ExactBatchNorm
from wekws_tpu.ops.fused_mdtc_train import (
    fused_tcn_block_train as jax_fused_block,
)
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.models.layers import BatchNorm
from wekws_tpu_torch.models.mdtc import TCNBlock
from wekws_tpu_torch.ops.fused_mdtc_train import (
    FLAT_PASSES,
    PARAM_KEYS,
    PASSES,
    SM_SMEM,
    SMEM_LIMIT,
    _PASS_VALUES,
    _ds0,
    _tiles,
    b3_bf16_rows,
    b3_bf16_staged,
    b4_smem_bytes,
    b4_tile_rows,
    bf16_tile_rows,
    blocks_per_sm,
    f3_bf16_staged,
    f3_window_bytes,
    f1_tile_rows,
    flat_tile_rows,
    fused_tcn_block_train,
    tile_smem_bytes,
    trace_pass_inputs,
)
from wekws_tpu_torch.tools.from_jax import grads_from_jax, model_from_jax

C, K = 8, 3


def _params(rng, c=C, k=K):
    def r(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"dw_kernel": r(k, 1, c), "dw_bias": r(c),
         "pw1_kernel": r(c, c), "pw1_bias": r(c, scale=0.1),
         "pw2_kernel": r(c, c), "pw2_bias": r(c, scale=0.1)}
    for i in range(3):
        p[f"bn{i}_scale"] = 1.0 + r(c, scale=0.1)
        p[f"bn{i}_bias"] = r(c, scale=0.1)
    return p


def _close_grad(got, want, name):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * scale, f"{name}: {err} vs {scale}"


def _loss_weights(y_shape, rng):
    return rng.standard_normal(y_shape).astype(np.float32)


def _port_block(p, dilation):
    """Port TCNBlock (plain modules, training mode) holding ``p``."""
    k, _, c = p["dw_kernel"].shape
    blk = TCNBlock(c, c, k, dilation).train()
    with torch.no_grad():
        blk.conv1.conv.weight.copy_(torch.from_numpy(p["dw_kernel"])
                                    .permute(2, 1, 0))
        blk.conv1.conv.bias.copy_(torch.from_numpy(p["dw_bias"]))
        blk.conv1.pointwise.weight.copy_(
            torch.from_numpy(p["pw1_kernel"]).t()[:, :, None])
        blk.conv1.pointwise.bias.copy_(torch.from_numpy(p["pw1_bias"]))
        blk.conv2.weight.copy_(torch.from_numpy(p["pw2_kernel"])
                               .t()[:, :, None])
        blk.conv2.bias.copy_(torch.from_numpy(p["pw2_bias"]))
        for i, bn in enumerate((blk.conv1.bn, blk.bn1, blk.bn2)):
            bn.weight.copy_(torch.from_numpy(p[f"bn{i}_scale"]))
            bn.bias.copy_(torch.from_numpy(p[f"bn{i}_bias"]))
    return blk


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_fused_block_matches_jax(dilation):
    """Forward, the six batch statistics and every gradient, B=3 (not
    a multiple of any tile) x T=21, against JAX's fused kernels, JAX's
    unfused ``ref_block`` and autograd of the port's unfused block."""
    rng = np.random.default_rng(dilation)
    p = _params(rng)
    x = rng.standard_normal((3, 21, C)).astype(np.float32)
    cot = _loss_weights(x.shape, rng)
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def jax_loss(fn):
        def loss(xx, pp):
            y, _ = fn(xx, pp)
            return jnp.sum(y * cot)
        return jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), jp)

    def fused(xx, pp):
        return jax_fused_block(xx, pp, K, dilation, 1e-5, 3)

    y_j, stats_j = fused(jnp.asarray(x), jp)
    y_ref, stats_ref = ref_block(jnp.asarray(x), jp, k=K, dilation=dilation)
    grads_j = jax_loss(fused)
    grads_ref = jax_loss(lambda xx, pp: ref_block(xx, pp, k=K,
                                                  dilation=dilation))

    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, stats = fused_tcn_block_train(xt, leaves, K, dilation)
    (y * torch.from_numpy(cot)).sum().backward()
    for want in (y_j, y_ref):
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
    for key in stats_j:
        for want in (stats_j, stats_ref):
            np.testing.assert_allclose(stats[key].numpy(),
                                       np.asarray(want[key]), atol=1e-4,
                                       rtol=1e-4, err_msg=key)
    for dx_w, dp_w in (grads_j, grads_ref):
        _close_grad(xt.grad.numpy(), np.asarray(dx_w), "x")
        for key in PARAM_KEYS:
            _close_grad(leaves[key].grad.numpy(), np.asarray(dp_w[key]), key)

    # autograd of the port's unfused module block on the same weights
    blk = _port_block(p, dilation)
    xu = torch.from_numpy(x).requires_grad_()
    yu, _ = blk(xu, None)
    (yu * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(yu.detach().numpy(), y.detach().numpy(),
                               atol=1e-5, rtol=1e-5)
    _close_grad(xu.grad.numpy(), xt.grad.numpy(), "x (unfused)")
    grads_u = {
        "dw_kernel": blk.conv1.conv.weight.grad.permute(2, 1, 0),
        "pw1_kernel": blk.conv1.pointwise.weight.grad[:, :, 0].t(),
        "pw2_kernel": blk.conv2.weight.grad[:, :, 0].t(),
        "dw_bias": blk.conv1.conv.bias.grad,
        "pw1_bias": blk.conv1.pointwise.bias.grad,
        "pw2_bias": blk.conv2.bias.grad,
    }
    for i, bn in enumerate((blk.conv1.bn, blk.bn1, blk.bn2)):
        grads_u[f"bn{i}_scale"] = bn.weight.grad
        grads_u[f"bn{i}_bias"] = bn.bias.grad
    for key in PARAM_KEYS:
        _close_grad(leaves[key].grad.numpy(), grads_u[key].numpy(),
                    f"{key} (unfused)")


# (B, T, C, K, dilation): T not a multiple of the 64-row tile, T shorter
# than the halo (K-1) d, the narrowest kernel width, the most taps
SPLIT_CASES = [(2, 70, 8, 3, 2), (3, 5, 8, 3, 4), (2, 21, 32, 3, 1),
               (2, 40, 8, 8, 2)]


@pytest.mark.parametrize("b,t,c,k,dilation", SPLIT_CASES)
def test_b3_hands_ds0_to_b4(b, t, c, k, dilation):
    """The line between the last two backward passes: B3 returns JAX's
    dW1, db1, Σds0, Σds0·û (the fused JAX block's gradients of
    pw1_kernel, pw1_bias, bn0_bias, bn0_scale; 1e-4 of max(1, max
    |grad|), as ``test_fused_block_matches_jax``) and the ds0 of the
    ``_ds0`` chain (bitwise: the same ops); B4 fed that ds0, and no
    pointwise weight, returns the dx, dWd, dbd of autograd through the
    unfused TCNBlock (fp32 on the CPU: dx within 1e-5 of max(1, max
    |dx|); dWd and dbd within 1e-5 of the largest of the two, because
    dbd, the gradient of a bias that a BatchNorm follows, cancels to
    about zero and carries the rounding of terms as large as dWd's).
    Every pass is handed its own per-channel values and no others, as
    the kernels, which take tensors only, are replayed with them."""
    rng = np.random.default_rng(1000 * t + c + k)
    p = _params(rng, c, k)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    cot = _loss_weights(x.shape, rng)
    calls = trace_pass_inputs(
        torch.from_numpy(x), {key: torch.from_numpy(v)
                              for key, v in p.items()},
        torch.from_numpy(cot), dilation)
    for name, args in calls.items():
        values = [a for a in args if isinstance(a, dict)]
        assert len(values) == 1 and set(values[0]) == set(
            _PASS_VALUES[name]), name
    dw1, db1, sds0, sds0u, ds0 = PASSES["b3"](*calls["b3"])
    assert ds0.shape == x.shape
    assert torch.equal(ds0, _ds0(*calls["b3"])[3])

    jp = {key: jnp.asarray(v) for key, v in p.items()}

    def loss(xx, pp):
        y, _ = jax_fused_block(xx, pp, k, dilation, 1e-5, b)
        return jnp.sum(y * cot)

    _, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), jp)
    for got, key in ((dw1, "pw1_kernel"), (db1, "pw1_bias"),
                     (sds0, "bn0_bias"), (sds0u, "bn0_scale")):
        _close_grad(got.numpy(), np.asarray(gp[key]), key)

    b4_args = calls["b4"]
    assert b4_args[3] is ds0 or torch.equal(b4_args[3], ds0)
    assert sum(isinstance(a, torch.Tensor) and a.dim() == 2
               for a in b4_args) == 1  # the (K, C) taps, no (C, C) weight
    assert set(b4_args[5]) == {"a2", "c2", "dw_b", "mu0", "inv0", "coef0",
                               "sds0", "sds0u"}
    dx, dwd, dbd = PASSES["b4"](*b4_args)
    blk = _port_block(p, dilation)
    xu = torch.from_numpy(x).requires_grad_()
    yu, _ = blk(xu, None)
    (yu * torch.from_numpy(cot)).sum().backward()
    want_dwd = blk.conv1.conv.weight.grad.permute(2, 1, 0)[:, 0]
    sum_scale = max(float(want_dwd.abs().max()), 1.0)
    for got, want, scale, name in (
            (dx, xu.grad, max(float(xu.grad.abs().max()), 1.0), "dx"),
            (dwd, want_dwd, sum_scale, "dWd"),
            (dbd, blk.conv1.conv.bias.grad, sum_scale, "dbd")):
        err = float((got - want).abs().max())
        assert err <= 1e-5 * scale, f"{name}: {err} vs {scale}"


@pytest.mark.parametrize("t,c,halo,want", [
    (198, 64, 32, 50),    # four tiles of 50 and 48 frames, not 3 x 64 + 6
    (64, 64, 4, 64), (65, 32, 0, 33), (20, 64, 32, 20),
    (130, 128, 56, 44),   # C=128, K=8, d=8: fits without halving
    (198, 128, 130, 13),  # halved twice to fit a block's shared memory
])
def test_b4_tile_rows(t, c, halo, want):
    """B4's tile: equal cuts of an utterance of at most 64 frames,
    halved until the tile with its halos fits a block's shared memory;
    a halo that cannot fit raises."""
    rows = b4_tile_rows(t, c, halo)
    assert rows == want
    assert b4_smem_bytes(rows, c, halo) <= 232448
    assert -(-t // rows) * rows >= t


@pytest.mark.parametrize("name,b,t,c,want", [
    ("f3", 512, 198, 64, 1584), ("b2", 512, 198, 64, 1584),
    ("b3", 512, 198, 64, 1584),   # 101,376 frames in 64-row tiles
    ("f2", 512, 198, 64, 1584),   # 2,048 when cut per utterance
    ("f3", 512, 198, 128, 3168), ("b2", 512, 198, 128, 3168),  # 32 rows
    ("f2", 512, 198, 128, 3168),
    ("f3", 3, 70, 64, 4), ("b2", 3, 70, 32, 4),  # tiles span utterances
    ("f2", 3, 70, 64, 4),  # tile 1: frames 64-69 of one, 0-57 of the next
    ("b1", 512, 198, 64, 1584),   # 64 rows a block at a time at C=64
    ("b1", 512, 198, 128, 3168), ("b1", 3, 70, 32, 2),  # 32, 128 rows
    ("b1", 3, 70, 64, 4),
    ("f1", 512, 198, 64, 792),    # 128-row tiles: 2,048 when cut into
    ("f1", 512, 198, 128, 1584),  # 64-frame tiles per utterance
    ("f1", 3, 70, 32, 2), ("f1", 3, 70, 64, 2),  # tiles span utterances
])
def test_tiles_of_each_pass(name, b, t, c, want):
    """F1, F2, F3, B2 and B3 tile the flattened B x T frames (F1 twice
    F2's rows) and B1 streams them, so only the last tile is ragged."""
    assert _tiles(name, b, t, c, 64) == want


@pytest.mark.parametrize("name,b,t,c,want", [
    ("f3", 512, 198, 64, 792),    # 128-row tiles: 16 rows a warp
    ("f3", 512, 598, 64, 2392), ("f3", 512, 198, 128, 792),
    ("f3", 3, 70, 32, 2),         # 210 frames: a ragged second tile
    ("b2", 512, 198, 64, 1584),   # 64-row tiles at every width
    ("b2", 512, 198, 128, 1584), ("b2", 5, 77, 64, 7),
    ("f2", 512, 198, 128, 792),   # F3's body: its 128-row tiles
    ("b3", 512, 198, 128, 3168),  # B3: 32-row tiles
    ("b3", 512, 198, 64, 3168),
    ("b3", 3, 70, 32, 4),         # and 64 rows at C=32
])
def test_bf16_tiles_of_each_pass(name, b, t, c, want):
    """At bf16 F2's and F3's kernels (one body) cut the flattened frames
    into 128-row tiles and B2's into 64-row tiles at every width
    (``BF16_TILE_ROWS``), B3's into 32-row tiles (64 at C=32,
    ``b3_bf16_rows``)."""
    assert _tiles(name, b, t, c, 64, "bfloat16") == want
    assert bf16_tile_rows(name, c, "bfloat16") * want >= b * t
    assert bf16_tile_rows(name, c) == flat_tile_rows(c)
    if name == "b3":
        assert bf16_tile_rows(name, c, "bfloat16") == b3_bf16_rows(c) == (
            64 if c == 32 else 32)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,halo,staged", [
    (64, 32, True), (64, 56, True), (128, 32, True), (32, 700, True),
    (32, 1000, False), (64, 400, False), (128, 180, False)])
def test_f1_stages_two_windows_where_they_fit(c, halo, staged, precision):
    """F1 has no weights and one tile (its reduction's), so it keeps two
    windows of x (the tile's rows and the halo before them) while they
    fit in a block's shared memory, and streams its taps otherwise.  It
    has no bf16 variant: at bf16 the same kernel and bytes."""
    base = tile_smem_bytes("f1", c, 10 ** 6, precision)  # no window fits
    assert base == 4 * ((26 + 8) * c + flat_tile_rows(c) * (c + 4))
    assert f1_tile_rows(c) == 2 * flat_tile_rows(c)
    window = 4 * c * (f1_tile_rows(c) + halo)
    assert tile_smem_bytes("f1", c, halo, precision) == (
        base + 2 * window if staged else base)
    assert tile_smem_bytes("f1", c, halo, precision) <= SMEM_LIMIT


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [32, 64, 128])
@pytest.mark.parametrize("name", FLAT_PASSES)
def test_tile_smem_fits_a_block(name, c, precision):
    """F2's, F3's, B2's and B3's shared memory fits one block's 227 KB,
    and two blocks share an SM at C <= 64, as their launch bounds plan
    (F2 and F3 with their window of x at the flagship's largest halo,
    4 x 8).  At bf16 F2 holds W1 and F3 W1 and W2 as bf16 at row stride
    C + 8, both with the window of their 128-row tile; B2 its staged w,
    x and dy rows in float32, then W2, the dwg tile and two r tiles as
    bf16 at row stride C + 8; B3 its staged w and dy rows in float32,
    then W1, W2 and its dwg (then dv), s0 and r tiles as bf16 at row
    stride C + 8, and its window of x."""
    smem = tile_smem_bytes(name, c, 32, precision)
    assert smem <= SMEM_LIMIT
    assert blocks_per_sm(smem, c) == (2 if c <= 64 else 1)
    assert blocks_per_sm(smem, c) * (smem + 1024) <= SM_SMEM
    if (name, c, precision) == ("f3", 64, "float32"):
        # (26 + 8) x 64 + four 64 x 68 floats, then 96 rows of x
        assert smem == 78336 + 4 * 64 * (64 + 32)
    if (name, c, precision) == ("f2", 64, "float32"):
        # (26 + 8) x 64 + two 64 x 68 floats
        assert smem == 43520 + 4 * 64 * (64 + 32)
    if precision == "bfloat16" and name == "f1":
        assert smem == tile_smem_bytes(name, c, 32)
    if (name, c, precision) == ("f2", 64, "bfloat16"):
        # (26 + 8) x 64 floats and one 64 x 72 bf16 (W1), then a window
        # of 128 + 32 rows x 64 floats
        assert smem == 4 * 2176 + 2 * 64 * 72 + 4 * 64 * 160 == 58880
    if (name, c, precision) == ("f3", 64, "bfloat16"):
        # (26 + 8) x 64 floats and two 64 x 72 bf16 (W1, W2), then a
        # window of 128 + 32 rows x 64 floats
        assert smem == 4 * 2176 + 2 * 2 * 64 * 72 + 4 * 64 * 160 == 68096
    if (name, c, precision) == ("b2", 64, "bfloat16"):
        # 26 x 64 floats and three 64 x 64 float tiles (w, x, dy staged),
        # then (64 + 3 x 64) x 72 bf16 (W2; dwg; two r tiles)
        assert smem == 4 * (1664 + 3 * 64 * 64) + 2 * 256 * 72 == 92672
    if (name, c, precision) == ("b3", 64, "bfloat16"):
        # (26 + 8) x 64 floats and 32 x 64 floats each of w and dy,
        # (2 x 64 + 3 x 32) x 72 bf16 (W1, W2; dwg/dv, s0, r), then a
        # window of 32 + 32 rows x 64 floats
        assert smem == (4 * (2176 + 2 * 32 * 64) + 2 * 224 * 72
                        + 4 * 64 * 64) == 73728
        assert smem < tile_smem_bytes("b3", 64, 32)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,halo,staged", [
    (64, 32, True), (64, 538, True), (64, 539, False),
    (128, 56, True), (128, 58, True), (128, 59, False)])
def test_f3_stages_its_window_where_it_fits(c, halo, staged, precision):
    """F3 stages a tile's rows of x and the halo before them in shared
    memory where they fit beside its weights and tiles, and otherwise
    reads its taps from device memory: any dilation runs.  F2 stages
    its window where float32 F3 does (one rule for both).  At bf16 F2
    and F3 are one body, and both stage the window of their 128-row
    tile where F3's fits beside its constants and bf16 weights (C = 64:
    up to a halo of 674 frames; C = 128: up to 156), F2 with one weight
    matrix less."""
    if precision == "float32":
        for name in ("f3", "f2"):
            base = tile_smem_bytes(name, c, 10 ** 6, precision)
            assert tile_smem_bytes(name, c, halo, precision) == (
                base + f3_window_bytes(c, halo) if staged else base)
            assert tile_smem_bytes(name, c, halo, precision) <= SMEM_LIMIT
        return
    last = {64: 674, 128: 156}[c]
    assert f3_bf16_staged(c, halo) == (halo <= last)
    assert f3_bf16_staged(c, last) and not f3_bf16_staged(c, last + 1)
    for name, mats in (("f3", 2), ("f2", 1)):
        base = tile_smem_bytes(name, c, 10 ** 6, precision)
        assert base == 4 * (26 + 8) * c + mats * 2 * c * (c + 8)
        assert tile_smem_bytes(name, c, halo, precision) == (
            base + 4 * c * (128 + halo) if halo <= last else base)
        assert tile_smem_bytes(name, c, halo, precision) <= SMEM_LIMIT
        assert base + 4 * c * (128 + last) <= SMEM_LIMIT


@pytest.mark.parametrize("c,halo", [
    (64, 32), (64, 196), (64, 197), (64, 652), (64, 653),
    (32, 518), (32, 519), (32, 1430), (32, 1431), (128, 137), (128, 138)])
def test_b3_bf16_stages_its_window_where_it_fits(c, halo):
    """B3's bf16 kernel keeps one stage of a tile's w and dy rows and
    its r tile, and stages its window of x (the tile's rows and the halo
    before them) where it fits a block beside its constants and its bf16
    weights and tiles, else it reads x and its taps from device memory;
    two blocks share an SM at C <= 64 while the halo stays within 196
    frames at C = 64 (the flagship's is at most 32), 518 at C = 32, and
    at C = 128 the window is staged up to a halo of 137 (K = 5 at
    dilation 34)."""
    rows = b3_bf16_rows(c)
    base = (4 * ((26 + 8) * c + 2 * rows * c)
            + 2 * (2 * c + 3 * rows) * (c + 8))
    last = {32: 1430, 64: 652, 128: 137}[c]
    assert b3_bf16_staged(c, halo) == (halo <= last)
    smem = tile_smem_bytes("b3", c, halo, "bfloat16")
    window = 4 * c * (rows + halo) if halo <= last else 0
    assert smem == base + window
    assert smem <= SMEM_LIMIT
    if c == 128:
        assert blocks_per_sm(smem, c) == 1
    else:
        two = {32: 518, 64: 196}[c]
        assert blocks_per_sm(smem, c) == (1 if two < halo <= last else 2)


def test_b4_tile_rows_rejects_a_halo_over_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        b4_tile_rows(198, 128, 7 * 32)


def test_fused_block_rejects_bf16_and_wrong_taps():
    """``precision="bfloat16"``, once refused, runs (y float32 and
    finite, the statistics float32); a precision the passes do not have
    and the wrong number of taps raise."""
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy(v) for k, v in _params(rng).items()}
    x = torch.from_numpy(rng.standard_normal((2, 5, C)).astype(np.float32))
    y, stats = fused_tcn_block_train(x, p, K, 1, precision="bfloat16")
    assert y.dtype == torch.float32 and bool(y.isfinite().all())
    assert all(v.dtype == torch.float32 for v in stats.values())
    with pytest.raises(ValueError, match="precision"):
        fused_tcn_block_train(x, p, K, 1, precision="float16")
    with pytest.raises(ValueError, match="taps"):
        fused_tcn_block_train(x, p, K + 2, 1)


def test_training_batchnorm_matches_exact_bn():
    """Training-mode BatchNorm vs ExactBatchNorm: output, gradients and
    the running statistics (biased variance, momentum 0.9) 1e-5;
    ``num_batches_tracked`` counts the update."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8, 12, 6)) * 2 + 1).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    scale = (rng.standard_normal(6) + 1).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    ebn = ExactBatchNorm()
    stats0 = {"mean": jnp.asarray(rng.standard_normal(6), jnp.float32),
              "var": jnp.asarray(rng.random(6) + 0.5, jnp.float32)}
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def f(pp, xx):
        y, upd = ebn.apply({"params": pp, "batch_stats": stats0}, xx,
                           use_running_average=False,
                           mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (y_j, st_j)), (gp_j, gx_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    bn = BatchNorm(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.tensor(np.asarray(stats0["mean"])))
        bn.running_var.copy_(torch.tensor(np.asarray(stats0["var"])))
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(gp_j["scale"]), atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(gp_j["bias"]), atol=1e-4)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(st_j["mean"]), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(st_j["var"]), atol=1e-5)
    biased = x.reshape(-1, 6).var(axis=0)
    np.testing.assert_allclose(
        bn.running_var.numpy(),
        0.9 * np.asarray(stats0["var"]) + 0.1 * biased, atol=1e-5)
    assert int(bn.num_batches_tracked) == 1
    bn.eval()
    with torch.no_grad():
        bn(xt)
    assert int(bn.num_batches_tracked) == 1


MODEL_CONF = {
    "input_dim": 40, "output_dim": 1, "hidden_dim": 16,
    "preprocessing": {"type": "linear"},
    "backbone": {"type": "mdtc", "num_stack": 2, "stack_size": 2,
                 "kernel_size": 3, "hidden_dim": 16, "causal": True,
                 "fused_train": True},
}


def test_model_train_forward_matches_jax():
    """Whole fused MDTC model in training mode, same weights (bridged):
    posteriors 1e-4 (tests/test_fused_train.py pins JAX fused vs unfused
    at 2e-3), every updated BN running statistic 1e-4 (there 1e-3), the
    loss gradient by port parameter name 1e-4 of max(1, max |grad|), and
    the unfused port model agrees with the fused one."""
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((5, 30, 40)).astype(np.float32)
    lengths = np.array([30, 30, 22, 30, 9], np.int32)
    cot = rng.standard_normal((5, 30, 1)).astype(np.float32)
    jmodel = jax_init_model(MODEL_CONF)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                            lengths=jnp.asarray(lengths))
    params = variables["params"]

    def loss(pp):
        (probs, _), upd = jmodel.apply(
            {"params": pp, "batch_stats": variables["batch_stats"]},
            jnp.asarray(feats), lengths=jnp.asarray(lengths), train=True,
            mutable=["batch_stats"])
        return jnp.sum(probs * cot), (probs, upd["batch_stats"])

    (_, (probs_j, stats_j)), grads_j = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    want_stats = model_from_jax(jax.device_get(params),
                                jax.device_get(stats_j), MODEL_CONF)
    want_grads = grads_from_jax(jax.device_get(grads_j), MODEL_CONF)

    for fused in (True, False):
        conf = dict(MODEL_CONF, backbone=dict(MODEL_CONF["backbone"],
                                              fused_train=fused))
        model = model_from_jax(jax.device_get(params),
                               jax.device_get(variables["batch_stats"]),
                               conf).train()
        probs, _ = model(torch.from_numpy(feats),
                         lengths=torch.from_numpy(lengths))
        (probs * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(probs.detach().numpy(),
                                   np.asarray(probs_j), atol=1e-4)
        want = dict(want_stats.named_buffers())
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                           atol=1e-4, err_msg=name)
            elif name.endswith("num_batches_tracked"):
                assert int(buf) == 1, name
        named = dict(model.named_parameters())
        assert set(want_grads) == set(named)
        for name, g in want_grads.items():
            _close_grad(named[name].grad.numpy(), g.numpy(), name)


def test_model_training_knobs_raise():
    """The knobs that raised build on the fused model: at ``dtype:
    bfloat16`` every block keeps ``fused_train`` and runs the passes at
    bf16 precision; ``bn_dtype`` leaves the precision float32 (the fused
    block ignores it, as JAX's does); ``remat`` marks every block;
    ``ghost_bn: 4`` keeps the flag but takes the module route with
    GhostBatchNorm.  ``dtype: float32`` keeps the fused float32 route."""
    from wekws_tpu_torch.models.layers import GhostBatchNorm

    def blocks(patch):
        model = init_model(dict(MODEL_CONF, **patch)).train()
        out = [blk for blk in model.backbone.modules()
               if isinstance(blk, TCNBlock)]
        assert len(out) == 5 and all(blk.fused_train for blk in out)
        return out

    assert all(blk.precision == "bfloat16"
               for blk in blocks({"dtype": "bfloat16"}))
    assert all(blk.precision == "float32" and blk._fused(None)
               for blk in blocks({"backbone": dict(
                   MODEL_CONF["backbone"], bn_dtype="bfloat16")}))
    assert all(blk.remat for blk in blocks({"backbone": dict(
        MODEL_CONF["backbone"], remat=True)}))
    for blk in blocks({"backbone": dict(MODEL_CONF["backbone"], ghost_bn=4)}):
        assert not blk._fused(None)
        assert isinstance(blk.bn1, GhostBatchNorm)
    model = init_model(dict(MODEL_CONF, dtype="float32"))
    assert all(blk.fused_train and blk.precision == "float32"
               for blk in model.backbone.modules()
               if isinstance(blk, TCNBlock))
