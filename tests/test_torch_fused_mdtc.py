"""Port fused MDTC (plain version on the CPU) against the JAX Pallas
kernel in interpret mode, and the serving builders against JAX's.
The CUDA kernel's own test is tests/test_torch_kernels.py."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.ops import extract_mdtc_weights as jax_extract_mdtc_weights
from wekws_tpu.ops import fused_mdtc_forward as jax_fused_mdtc_forward
from wekws_tpu.ops import fused_mdtc_stream as jax_fused_mdtc_stream
from wekws_tpu.ops import init_stream_cache as jax_init_stream_cache
from wekws_tpu.ops.serving import build_fused_forward as jax_build_forward
from wekws_tpu.ops.serving import build_fused_stream as jax_build_stream
from wekws_tpu_torch.ops.fused_mdtc import (
    extract_mdtc_weights,
    fused_mdtc_forward,
    fused_mdtc_stream,
    init_stream_cache,
)
from wekws_tpu_torch.ops.serving import build_fused_forward, build_fused_stream
from wekws_tpu_torch.tools.from_jax import model_from_jax

CONF = {
    "input_dim": 40, "output_dim": 2, "hidden_dim": 32,
    "preprocessing": {"type": "linear"},
    "backbone": {"type": "mdtc", "num_stack": 2, "stack_size": 3,
                 "kernel_size": 5, "hidden_dim": 32, "causal": True},
}


def _pair(seed=0, conf=CONF):
    """Flax model/variables (BN stats nudged) and the bridged port."""
    model = jax_init_model(conf)
    x0 = np.zeros((1, 8, 40), np.float32)
    variables = model.init(jax.random.PRNGKey(seed), x0)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * np.arange(a.size, dtype=np.float32)
        .reshape(a.shape) / max(a.size, 1),
        variables["batch_stats"],
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return (model, {"params": params, "batch_stats": stats},
            model_from_jax(params, stats, conf))


@pytest.fixture(scope="module")
def weights():
    jmodel, variables, pmodel = _pair()
    jw = jax_extract_mdtc_weights(jmodel.backbone,
                                  variables["params"]["backbone"],
                                  variables["batch_stats"]["backbone"])
    return jw, extract_mdtc_weights(pmodel.backbone)


def test_forward_matches_pallas_interpret(weights, rng):
    jw, pw = weights
    x = (rng.standard_normal((2, 48, 32)) * 0.5).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused_mdtc_forward(x, *jw[:-1], jw[-1], 5, 3)
    got = fused_mdtc_forward(torch.from_numpy(x), *pw[:-1], pw[-1], 5, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)


def test_stream_matches_pallas_interpret_and_full(weights, rng):
    jw, pw = weights
    b, t, c = 2, 48, 32
    pad_max = 4 * max(pw[-1])
    x = (rng.standard_normal((b, t, c)) * 0.5).astype(np.float32)
    jcache = jax_init_stream_cache(len(jw[-1]), b, pad_max, c)
    pcache = init_stream_cache(len(pw[-1]), b, pad_max, c)
    jouts, pouts = [], []
    with pltpu.force_tpu_interpret_mode():
        for s in range(0, t, 12):
            y, jcache = jax_fused_mdtc_stream(x[:, s:s + 12], jcache,
                                              *jw[:-1], jw[-1], 5, 3)
            jouts.append(np.asarray(y))
            y, pcache = fused_mdtc_stream(
                torch.from_numpy(np.ascontiguousarray(x[:, s:s + 12])),
                pcache, *pw[:-1], pw[-1], 5, 3)
            pouts.append(y.numpy())
    streamed = np.concatenate(pouts, axis=1)
    np.testing.assert_allclose(streamed, np.concatenate(jouts, axis=1),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(pcache.numpy(), np.asarray(jcache),
                               atol=2e-4, rtol=1e-3)
    full = fused_mdtc_forward(torch.from_numpy(x), *pw[:-1], pw[-1], 5, 3)
    np.testing.assert_allclose(streamed, full.numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("head,softmax", [
    (None, False), ("element", True), ("identity", False),
])
def test_serving_builders_match_jax(rng, head, softmax):
    conf = CONF if head is None else dict(
        CONF, classifier={"type": head, "dropout": 0.0})
    jmodel, variables, pmodel = _pair(seed=1, conf=conf)
    x = rng.standard_normal((2, 40, 40)).astype(np.float32)
    lengths = np.asarray([40, 25], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            jax_build_forward(jmodel, variables, softmax)(x, lengths))
        jstep, jinit = jax_build_stream(jmodel, variables, softmax)
        jcache, jouts = jinit(2), []
        for s in range(0, 40, 8):
            y, jcache = jstep(x[:, s:s + 8], jcache)
            jouts.append(np.asarray(y))
    got = build_fused_forward(pmodel, softmax, device="cpu")(x, lengths)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-3)
    pstep, pinit = build_fused_stream(pmodel, softmax, device="cpu")
    pcache, pouts = pinit(2), []
    for s in range(0, 40, 8):
        y, pcache = pstep(x[:, s:s + 8], pcache)
        pouts.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(pouts, axis=1),
                               np.concatenate(jouts, axis=1), atol=5e-4,
                               rtol=1e-3)


def test_unsupported_shapes_return_none_or_raise():
    from wekws_tpu_torch.models import init_model

    conf = dict(CONF, preprocessing={"type": "none"})
    assert build_fused_forward(init_model(conf), device="cpu") is None
    model = init_model(CONF)
    model.backbone = torch.nn.Identity()
    with pytest.raises(NotImplementedError,
                       match="no fused serving kernel for Identity"):
        build_fused_stream(model, device="cpu")


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "cache"])
def test_wrapper_rejects_bad_inputs(weights, bad):
    _, pw = weights
    x = torch.zeros((2, 16, 32))
    cache = init_stream_cache(len(pw[-1]), 2, 4 * max(pw[-1]), 32)
    if bad == "dtype":
        x = x.double()
    elif bad == "shape":
        x = torch.zeros((2, 16, 16))
    elif bad == "contiguous":
        x = torch.zeros((2, 32, 16)).transpose(1, 2)
    else:
        cache = cache[:, :, :5]
    with pytest.raises((TypeError, ValueError)):
        fused_mdtc_stream(x, cache, *pw[:-1], pw[-1], 5, 3)


# ---- the kernel's plan: cluster, thread map, windows, shared memory

from wekws_tpu_torch.ops import fused_mdtc as fm  # noqa: E402


def _fits_16(plan):
    """A card on which 16 spread clusters of up to 7 blocks fit at once
    and only 14 of 8 (an H100 whose smallest GPCs hold 14 SMs)."""
    return 16 if plan["cluster"] <= 7 else 14


@pytest.mark.parametrize("b,t,c,stream,want", [
    # offline scoring, B=16 x 2 s at the flagship width: the portable rule
    # without the card, 7 spread blocks a row with it
    (16, 198, 64, False, {"cluster": 8, "rows": 25, "splits": 1,
                          "rows_per_thread": 2, "window": "smem", "nbuf": 2,
                          "spread": False}),
    # the engine's step, 16 streams x 8 frames: a block a row, the depth
    # split over two threads
    (16, 8, 64, True, {"cluster": 1, "rows": 8, "splits": 2,
                       "rows_per_thread": 1, "window": "smem", "nbuf": 2}),
    (1, 1, 64, True, {"cluster": 1, "rows": 1, "splits": 2}),
    (16, 7, 64, True, {"cluster": 1, "rows": 7, "splits": 2}),
    (64, 198, 64, False, {"cluster": 4, "rows": 50, "rows_per_thread": 4}),
    (4, 1024, 64, False, {"cluster": 8, "rows": 128, "window": "smem",
                          "nbuf": 2}),
    # long utterances: one weight buffer (C=64), the outputs in the
    # device buffer (C=128)
    (1, 2048, 64, False, {"cluster": 8, "rows": 256, "window": "smem",
                          "nbuf": 1}),
    (4, 2048, 128, False, {"cluster": 8, "window": "staged", "nbuf": 1}),
    (16, 198, 32, False, {"cluster": 8, "rows_per_thread": 1, "nbuf": 2}),
    (16, 198, 128, False, {"cluster": 8, "rows_per_thread": 4, "nbuf": 1}),
    (16, 8, 128, True, {"cluster": 1, "splits": 1, "nbuf": 1}),
])
def test_plan_at_the_main_shapes(b, t, c, stream, want):
    plan = fm.mdtc_plan(b, t, c, 5, 32)
    for key, value in want.items():
        assert plan[key] == value, key
    n, rows = plan["cluster"], plan["rows"]
    assert n * rows >= t > (n - 1) * rows
    assert plan["smem"] == fm.mdtc_smem_bytes(
        t, c, 5, 32, n, plan["rows_per_thread"], plan["splits"],
        plan["window"], plan["nbuf"]) <= fm.SMEM_LIMIT
    groups = fm.THREADS // (plan["splits"] * (c // 4))
    assert plan["tile"] == groups * plan["rows_per_thread"]
    if plan["window"] == "smem" and plan["rows_per_thread"] < 4:
        assert plan["tile"] >= rows  # one sub-tile a layer
    # with the card's residency: spread clusters where they all fit
    spread = fm.mdtc_plan(b, t, c, 5, 32, resident=_fits_16)
    if t >= 2 * fm.MIN_ROWS and b <= 16:  # as many as _fits_16 holds
        assert spread["spread"] and spread["smem"] >= fm.SPREAD_SMEM
        assert _fits_16(spread) >= b and b * spread["cluster"] <= fm.SMS
    else:
        assert spread == plan


def test_plan_spreads_over_the_card():
    """Offline B=16 x T=198: 7 blocks a row (29 frames each, 112 SMs)
    where clusters of 8 would not all fit; none spread when too few fit;
    ``fit_plan`` gives the plan of any cluster size, spread or not."""
    got = fm.mdtc_plan(16, 198, 64, 5, 32, resident=_fits_16)
    assert (got["cluster"], got["rows"], got["spread"]) == (7, 29, True)
    assert got == fm.fit_plan(198, 64, 5, 32, 7, True)
    assert fm.mdtc_plan(16, 198, 64, 5, 32, resident=lambda p: 1) == \
        fm.mdtc_plan(16, 198, 64, 5, 32) == fm.fit_plan(198, 64, 5, 32, 8,
                                                        False)
    fixed = fm.fit_plan(198, 64, 5, 32, 3, False)
    assert (fixed["cluster"], fixed["rows"], fixed["spread"]) == (3, 66, False)
    assert fm.fit_plan(198, 64, 5, 32, 8, True)["smem"] == fm.SPREAD_SMEM


@pytest.mark.parametrize("b,t,stream", [(1, 2048, False), (2, 300, False),
                                        (16, 8, True), (1, 1, True)])
@pytest.mark.parametrize("c", [32, 64, 128])
@pytest.mark.parametrize("pad_max", [256, 1024])
def test_plan_of_a_long_halo(b, t, stream, c, pad_max):
    """A halo longer than a block's shared memory holds (a dilation of 64
    or 256 at K=5) still has a plan: the windows in shared memory where
    they fit, else each sub-tile's window staged, else the rows each tap
    reads (K slices of a sub-tile), whose shared memory does not grow
    with pad_max."""
    plan = fm.mdtc_plan(b, t, c, 5, pad_max)
    assert plan["smem"] == fm.mdtc_smem_bytes(
        t, c, 5, pad_max, plan["cluster"], plan["rows_per_thread"],
        plan["splits"], plan["window"], plan["nbuf"]) <= fm.SMEM_LIMIT
    earlier = fm.WINDOWS[:fm.WINDOWS.index(plan["window"])]
    for window in earlier:  # each preferred one does not fit
        assert fm.mdtc_smem_bytes(t, c, 5, pad_max, plan["cluster"], 1,
                                  plan["splits"], window, 1) > fm.SMEM_LIMIT
    if plan["window"] == "taps":
        assert plan["smem"] == fm.mdtc_smem_bytes(
            t, c, 5, 0, plan["cluster"], plan["rows_per_thread"],
            plan["splits"], "taps", plan["nbuf"])
    if c == 128:  # the weights leave no room for a window of 256 rows
        assert plan["window"] == "taps"


@pytest.mark.parametrize("rows,c,want", [
    (1, 64, (1, 2)), (8, 64, (1, 2)), (9, 64, (1, 1)), (16, 64, (1, 1)),
    (25, 64, (2, 1)), (33, 64, (3, 1)), (48, 64, (3, 1)), (50, 64, (4, 1)),
    (128, 64, (4, 1)),
    (16, 32, (1, 2)), (17, 32, (1, 1)), (33, 32, (2, 1)),
    (4, 128, (1, 2)), (8, 128, (1, 1)), (24, 128, (3, 1)), (25, 128, (4, 1)),
])
def test_thread_map(rows, c, want):
    """256 threads as C/4 channel quads x row groups x halves of the
    depth: halves where half the groups cover the rows, else the fewest
    rows a thread (1 to 4)."""
    assert fm.thread_map(rows, c) == want
    rpt, splits = want
    groups = fm.THREADS // (splits * (c // 4))
    assert groups * rpt >= rows or rpt == 4


def test_smem_bytes_of_the_main_plans():
    """Two weight buffers (W1, W2, 5 taps, 3 biases), two windows of 32
    halo + 25 rows of 64 floats, a 32-row tile at row stride 68, two
    mbarriers: 107,536 bytes at B=16 x T=198, so two blocks fit an SM."""
    assert fm.mdtc_smem_bytes(198, 64, 5, 32, 8, 2, 1, "smem", 2) == 4 * (
        2 * (2 * 64 * 64 + 8 * 64) + 2 * 57 * 64 + 32 * 68 + 4) == 107536
    assert 2 * (107536 + 1024) <= 233472
    # streaming: a window of the cache and 8 rows, an 8-row tile
    assert fm.mdtc_smem_bytes(8, 64, 5, 32, 1, 1, 2, "smem", 2) == 4 * (
        2 * 8704 + 2 * 40 * 64 + 8 * 68 + 4)
    # the device-buffer plans: one staged window of halo + tile, or K
    # slices of the tile
    assert fm.mdtc_smem_bytes(2048, 128, 5, 32, 8, 4, 1, "staged", 1) == 4 * (
        2 * 128 * 128 + 8 * 128 + (32 + 32) * 128 + 32 * 132 + 4)
    assert fm.mdtc_smem_bytes(2048, 128, 5, 1024, 8, 3, 1, "taps", 1) == 4 * (
        2 * 128 * 128 + 8 * 128 + 5 * 24 * 128 + 24 * 132 + 4)


def test_plan_is_mdtc_by_default():
    """The plan functions, generalised by the layer's weights, give
    MDTC's plan unless asked for another layer: never a W in slices nor
    more than 4 rows a thread."""
    for b, t, c in ((16, 198, 64), (16, 8, 64), (4, 2048, 128)):
        assert fm.mdtc_plan(b, t, c, 5, 32) == fm.mdtc_plan(
            b, t, c, 5, 32, arch="mdtc")
        assert fm.fit_plan(t, c, 5, 32, 4, True) == fm.fit_plan(
            t, c, 5, 32, 4, True, "mdtc")
    assert fm.rows_choices(256) == fm.ROWS_PER_THREAD == (1, 2, 3, 4)
    assert fm.thread_map(200, 128) == (4, 1)
    assert fm.weight_floats("mdtc", 128, 5) == (2 * 128 * 128 + 8 * 128, 0)
    assert fm.mdtc_smem_bytes(198, 64, 5, 32, 8, 2, 1, "smem", 2) == \
        fm.mdtc_smem_bytes(198, 64, 5, 32, 8, 2, 1, "smem", 2, "mdtc")
