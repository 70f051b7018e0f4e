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
    _ds0,
    _tiles,
    b4_smem_bytes,
    b4_tile_rows,
    blocks_per_sm,
    f3_window_bytes,
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
    about zero and carries the rounding of terms as large as dWd's)."""
    rng = np.random.default_rng(1000 * t + c + k)
    p = _params(rng, c, k)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    cot = _loss_weights(x.shape, rng)
    calls = trace_pass_inputs(
        torch.from_numpy(x), {key: torch.from_numpy(v)
                              for key, v in p.items()},
        torch.from_numpy(cot), dilation)
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
    ("f3", 512, 198, 128, 3168), ("b2", 512, 198, 128, 3168),  # 32 rows
    ("f3", 3, 70, 64, 4), ("b2", 3, 70, 32, 4),  # tiles span utterances
    ("f2", 512, 198, 64, 2048),   # per utterance: 3 x 64 + 6 frames
    ("b1", 3, 70, 64, 6),
])
def test_tiles_of_each_pass(name, b, t, c, want):
    """F3, B2 and B3 tile the flattened B x T frames, so only the last
    tile is ragged; F1, F2 and B1 cut each utterance into 64 frames."""
    assert _tiles(name, b, t, c, 64) == want


@pytest.mark.parametrize("c", [32, 64, 128])
@pytest.mark.parametrize("name", FLAT_PASSES)
def test_tile_smem_fits_a_block(name, c):
    """F3's, B2's and B3's shared memory fits one block's 227 KB, and
    two blocks share an SM at C <= 64, as their launch bounds plan (F3
    with its window of x at the flagship's largest halo, 4 x 8)."""
    smem = tile_smem_bytes(name, c, 32)
    assert smem <= SMEM_LIMIT
    assert blocks_per_sm(smem, c) == (2 if c <= 64 else 1)
    assert blocks_per_sm(smem, c) * (smem + 1024) <= SM_SMEM
    if (name, c) == ("f3", 64):  # (26 + 8) x 64 + four 64 x 68 floats,
        assert smem == 78336 + 4 * 64 * (64 + 32)  # then 96 rows of x


@pytest.mark.parametrize("c,halo,staged", [
    (64, 32, True), (64, 538, True), (64, 539, False),
    (128, 56, True), (128, 58, True), (128, 59, False)])
def test_f3_stages_its_window_where_it_fits(c, halo, staged):
    """F3 stages a tile's rows of x and the halo before them in shared
    memory where they fit beside its weights and tiles, and otherwise
    reads its taps from device memory: any dilation runs."""
    base = tile_smem_bytes("f3", c, 10 ** 6)  # no window fits
    assert tile_smem_bytes("f3", c, halo) == (
        base + f3_window_bytes(c, halo) if staged else base)
    assert tile_smem_bytes("f3", c, halo) <= SMEM_LIMIT


def test_b4_tile_rows_rejects_a_halo_over_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        b4_tile_rows(198, 128, 7 * 32)


def test_fused_block_rejects_bf16_and_wrong_taps():
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy(v) for k, v in _params(rng).items()}
    x = torch.zeros((2, 5, C))
    with pytest.raises(NotImplementedError, match="training knobs"):
        fused_tcn_block_train(x, p, K, 1, precision="bfloat16")
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
    for patch in ({"dtype": "bfloat16"},
                  {"backbone": dict(MODEL_CONF["backbone"],
                                    bn_dtype="bfloat16")},
                  {"backbone": dict(MODEL_CONF["backbone"], remat=True)},
                  {"backbone": dict(MODEL_CONF["backbone"], ghost_bn=4)}):
        with pytest.raises(NotImplementedError, match="item 15"):
            init_model(dict(MODEL_CONF, **patch))
    model = init_model(dict(MODEL_CONF, dtype="float32"))
    assert all(blk.fused_train for blk in model.backbone.modules()
               if isinstance(blk, TCNBlock))
