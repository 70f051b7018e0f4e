"""Port fused DS-TCN (ops/fused_tcn.py plain version, ops/serving.py
build_fused_forward / build_fused_stream) against the JAX package's
Pallas kernel in interpret mode and its build_fused_* functions, on the
same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.ops.fused_tcn import extract_ds_tcn_weights as jax_extract
from wekws_tpu.ops.fused_tcn import fused_ds_tcn as jax_fused_ds_tcn
from wekws_tpu.ops.serving import build_fused_forward as jax_build_forward
from wekws_tpu.ops.serving import build_fused_stream as jax_build_stream
from wekws_tpu_torch.ops.fused_tcn import (
    extract_ds_tcn_weights,
    fused_ds_tcn,
    fused_ds_tcn_plain,
    init_tcn_cache,
)
from wekws_tpu_torch.ops.serving import build_fused_forward, build_fused_stream
from wekws_tpu_torch.tools.from_jax import model_from_jax

# the JAX suite's own bound for its fused kernels against flax
ATOL, RTOL = 2e-4, 1e-3


def _conf(ds=True, backbone=None, hidden=32):
    return {
        "input_dim": 40, "output_dim": 2, "hidden_dim": hidden,
        "preprocessing": {"type": "linear"},
        "backbone": backbone or {"type": "tcn", "ds": ds, "num_layers": 3,
                                 "kernel_size": 8, "dropout": 0.0},
    }


def _jax_and_port(conf, seed=0):
    model = jax_init_model(conf)
    x0 = np.zeros((1, 8, conf["input_dim"]), np.float32)
    variables = model.init(jax.random.PRNGKey(seed), x0)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.03 * np.arange(a.size, dtype=np.float32)
        .reshape(a.shape) / max(a.size, 1),
        variables["batch_stats"],
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return model, {"params": params, "batch_stats": stats}, model_from_jax(
        params, stats, conf)


def test_extract_weights_equal_jax():
    jmodel, variables, pmodel = _jax_and_port(_conf())
    want = jax_extract(jmodel.backbone, variables["params"]["backbone"],
                       variables["batch_stats"]["backbone"])
    got = extract_ds_tcn_weights(pmodel.backbone)
    assert got[-1] == want[-1] == (1, 2, 4)
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("t", [40, 8, 3])
def test_plain_matches_pallas_interpret(rng, t):
    """Outputs and new cache against the Pallas kernel in interpret
    mode, from a random carried cache; T = 8 and 3 are shorter than
    pad_max = 28, where the new cache mixes old rows and new frames."""
    jmodel, variables, pmodel = _jax_and_port(_conf(), seed=1)
    *stacks, dil = extract_ds_tcn_weights(pmodel.backbone)
    x = rng.standard_normal((3, t, 32)).astype(np.float32)
    cache = rng.standard_normal((3, 3, 28, 32)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_y, want_c = jax_fused_ds_tcn(
            jnp.asarray(x), jnp.asarray(cache),
            *[jnp.asarray(s.numpy()) for s in stacks], dil, 8)
    before = fused_ds_tcn.launches
    got_y, got_c = fused_ds_tcn(torch.from_numpy(x), torch.from_numpy(cache),
                                *stacks, dil, 8)
    assert fused_ds_tcn.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=ATOL,
                               rtol=RTOL)


def test_plain_chunked_equals_whole(rng):
    _, _, pmodel = _jax_and_port(_conf(), seed=2)
    *stacks, dil = extract_ds_tcn_weights(pmodel.backbone)
    x = torch.from_numpy(rng.standard_normal((2, 40, 32)).astype(np.float32))
    full, full_c = fused_ds_tcn_plain(x, init_tcn_cache(3, 2, 28, 32),
                                      *stacks, dil, 8)
    cache = init_tcn_cache(3, 2, 28, 32)
    outs = []
    for s in range(0, 40, 8):
        y, cache = fused_ds_tcn_plain(x[:, s:s + 8].contiguous(), cache,
                                      *stacks, dil, 8)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(cache, full_c, atol=1e-5, rtol=1e-5)


def test_fused_forward_and_stream_match_jax(rng):
    """DS-TCN with linear preprocessing, linear head and sigmoid: the
    port's fused forward and 8-frame stream against JAX's (in interpret
    mode) and against the module forward."""
    conf = _conf()
    jmodel, variables, pmodel = _jax_and_port(conf, seed=3)
    x = rng.standard_normal((2, 40, 40)).astype(np.float32)
    lengths = np.asarray([40, 31])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_build_forward(jmodel, variables)(
            jnp.asarray(x), jnp.asarray(lengths)))
        jstep, jinit = jax_build_stream(jmodel, variables)
        jcache, jouts = jinit(2), []
        for s in range(0, 40, 8):
            y, jcache = jstep(jnp.asarray(x[:, s:s + 8]), jcache)
            jouts.append(np.asarray(y))
    forward = build_fused_forward(pmodel, device="cpu")
    got = forward(x, lengths)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    with torch.inference_mode():
        module, _ = pmodel(torch.from_numpy(x),
                           lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), module.numpy(), atol=1e-5,
                               rtol=1e-5)
    step, init_cache = build_fused_stream(pmodel, device="cpu")
    cache, outs = init_cache(2), []
    assert tuple(cache.shape) == tuple(jcache.shape) == (3, 2, 28, 32)
    for s in range(0, 40, 8):
        y, cache = step(x[:, s:s + 8], cache)
        outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1),
                               np.concatenate(jouts, axis=1), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), atol=ATOL,
                               rtol=RTOL)


def test_full_conv_tcn_gives_none_and_gru_raises():
    """As in the JAX package a full-conv TCN has no fused path (None);
    a DS-TCN without linear preprocessing neither.  A GRU model builds
    (it runs as modules), and the fused builders raise for it."""
    from wekws_tpu_torch.models import GRU, init_model

    conf = _conf(ds=False)
    jmodel, variables, pmodel = _jax_and_port(conf)
    assert jax_build_forward(jmodel, variables) is None
    assert build_fused_forward(pmodel, device="cpu") is None
    assert build_fused_stream(pmodel, device="cpu") is None
    conf = dict(_conf(), input_dim=32, preprocessing={"type": "none"})
    assert build_fused_forward(init_model(conf), device="cpu") is None
    gru = init_model(_conf(backbone={"type": "gru", "num_layers": 1}))
    assert isinstance(gru.backbone, GRU)
    for build in (build_fused_forward, build_fused_stream):
        with pytest.raises(NotImplementedError, match="GRU"):
            build(gru, device="cpu")


def test_wrapper_checks_its_inputs(rng):
    _, _, pmodel = _jax_and_port(_conf())
    *stacks, dil = extract_ds_tcn_weights(pmodel.backbone)
    x = torch.zeros((2, 8, 32))
    with pytest.raises(ValueError, match="cache"):
        fused_ds_tcn(x, torch.zeros((3, 2, 27, 32)), *stacks, dil, 8)
    with pytest.raises(TypeError, match="float32"):
        fused_ds_tcn(x.double(), init_tcn_cache(3, 2, 28, 32), *stacks, dil,
                     8)
    with pytest.raises(ValueError, match="ds variant"):
        extract_ds_tcn_weights(
            _jax_and_port(_conf(ds=False))[2].backbone)


# ---- the recipes' widths: 48 (synthetic) and 256 (hi_xiaowen)


@pytest.mark.parametrize("hidden", [48, 256])
def test_recipe_widths_match_jax(rng, hidden):
    """At the widths the CUDA kernel used to refuse: the plain version
    against the Pallas kernel in interpret mode (T = 20 and 5, below
    pad_max), and the fused forward and 8-frame stream against JAX's
    build_fused_* and the module forward, on the same weights."""
    conf = _conf(hidden=hidden)
    jmodel, variables, pmodel = _jax_and_port(conf, seed=4)
    *stacks, dil = extract_ds_tcn_weights(pmodel.backbone)
    for t in (20, 5):
        x = rng.standard_normal((2, t, hidden)).astype(np.float32)
        cache = rng.standard_normal((3, 2, 28, hidden)).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            want_y, want_c = jax_fused_ds_tcn(
                jnp.asarray(x), jnp.asarray(cache),
                *[jnp.asarray(s.numpy()) for s in stacks], dil, 8)
        got_y, got_c = fused_ds_tcn(torch.from_numpy(x),
                                    torch.from_numpy(cache), *stacks, dil, 8)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                   atol=ATOL, rtol=RTOL)
    x = rng.standard_normal((2, 24, 40)).astype(np.float32)
    lengths = np.asarray([24, 17])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_build_forward(jmodel, variables)(
            jnp.asarray(x), jnp.asarray(lengths)))
        jstep, jinit = jax_build_stream(jmodel, variables)
        jcache, jouts = jinit(2), []
        for s in range(0, 24, 8):
            y, jcache = jstep(jnp.asarray(x[:, s:s + 8]), jcache)
            jouts.append(np.asarray(y))
    got = build_fused_forward(pmodel, device="cpu")(x, lengths)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    with torch.inference_mode():
        module, _ = pmodel(torch.from_numpy(x),
                           lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), module.numpy(), atol=1e-5,
                               rtol=1e-5)
    step, init_cache = build_fused_stream(pmodel, device="cpu")
    cache, outs = init_cache(2), []
    for s in range(0, 24, 8):
        y, cache = step(x[:, s:s + 8], cache)
        outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1),
                               np.concatenate(jouts, axis=1), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), atol=ATOL,
                               rtol=RTOL)


def test_kernel_takes_every_recipe_width():
    """Every DS-TCN recipe's hidden_dim is a width of the CUDA kernel."""
    import glob
    import os

    import yaml

    from wekws_tpu_torch.ops.fused_tcn import KERNEL_CHANNELS

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    widths = set()
    for path in glob.glob(os.path.join(root, "examples", "*", "conf",
                                       "*.yaml")):
        with open(path) as f:
            model = (yaml.safe_load(f) or {}).get("model") or {}
        backbone = model.get("backbone") or {}
        if backbone.get("type") == "tcn" and backbone.get("ds"):
            widths.add(model["hidden_dim"])
    assert {48, 64, 256} <= widths
    assert widths <= set(KERNEL_CHANNELS)


# ---- the kernel's plan for the DS-TCN layer (the MDTC kernel's body)

from wekws_tpu_torch.ops import fused_mdtc as fm  # noqa: E402

HEY_SNIPS_PAD = 7 * 8  # K=8, dilations 1, 2, 4, 8
EIGHT_LAYER_PAD = 7 * 128  # dilations 1 to 128


def _fits_16(plan):
    """A card on which 16 spread clusters of up to 6 blocks fit at once
    and fewer of 7 or 8 (an H100's GPCs, as the MDTC kernel found)."""
    return 16 if plan["cluster"] <= 6 else 14


@pytest.mark.parametrize("c", [48, 64, 256])
@pytest.mark.parametrize("b,t,want", [
    # offline scoring: clusters of 6 on the card, 33 frames a block
    (16, 198, {"cluster": 6, "rows": 33, "spread": True}),
    # the engine's step: a block a stream
    (16, 8, {"cluster": 1, "rows": 8, "spread": False}),
    (1, 1, {"cluster": 1, "rows": 1, "splits": 2}),
    (1, 2048, {"cluster": 8, "rows": 256, "spread": True}),
])
def test_plan_at_the_ds_tcn_shapes(c, b, t, want):
    """With the card's residency stubbed: the cluster, frames a block and
    the shared memory of the DS-TCN layer's plan; C=256 keeps W in a
    ring of slices (its layer inputs in the device buffer offline, one
    sub-tile of up to 9 rows a thread covering a block's frames)."""
    plan = fm.mdtc_plan(b, t, c, 8, HEY_SNIPS_PAD, resident=_fits_16,
                        arch="ds_tcn")
    for key, value in want.items():
        assert plan[key] == value, key
    n, rows = plan["cluster"], plan["rows"]
    assert n * rows >= t > (n - 1) * rows
    smem = fm.mdtc_smem_bytes(t, c, 8, HEY_SNIPS_PAD, n,
                              plan["rows_per_thread"], plan["splits"],
                              plan["window"], plan["nbuf"], "ds_tcn")
    assert smem <= fm.SMEM_LIMIT
    assert plan["smem"] == (max(smem, fm.SPREAD_SMEM) if plan["spread"]
                            else smem)
    assert plan["tile"] == (fm.row_groups(c, plan["splits"])
                            * plan["rows_per_thread"])
    assert plan["rows_per_thread"] in fm.rows_choices(c, "ds_tcn")
    if c == 256 and (b, t) == (16, 198):
        assert (plan["window"], plan["rows_per_thread"],
                plan["tile"]) == ("staged", 9, 36)
    elif (b, t) != (1, 2048) or c != 256:
        assert plan["window"] == "smem"
    if plan["window"] == "smem" and plan["rows_per_thread"] < 4:
        assert plan["tile"] >= rows  # one sub-tile a layer
    # DS-TCN's one W leaves more room than MDTC's two
    if c <= fm.MAX_RESIDENT:
        assert smem < fm.mdtc_smem_bytes(
            t, c, 8, HEY_SNIPS_PAD, n, plan["rows_per_thread"],
            plan["splits"], plan["window"], plan["nbuf"], "mdtc")


@pytest.mark.parametrize("c,window", [(48, "staged"), (64, "taps"),
                                      (256, "taps")])
def test_eight_layers_fall_to_the_device_buffer(c, window):
    """8 layers of dilations 1-128 (pad_max 896) over 2048 frames: the
    windows in shared memory do not fit, so the layer inputs stay in the
    device buffer: a staged window of halo + sub-tile where it fits (C =
    48), else only each tap's rows (whose shared memory does not grow
    with pad_max)."""
    plan = fm.mdtc_plan(1, 2048, c, 8, EIGHT_LAYER_PAD, arch="ds_tcn")
    assert plan["window"] == window
    rpt, splits, n = plan["rows_per_thread"], plan["splits"], plan["cluster"]
    for earlier in fm.WINDOWS[:fm.WINDOWS.index(window)]:
        assert fm.mdtc_smem_bytes(2048, c, 8, EIGHT_LAYER_PAD, n, 1, splits,
                                  earlier, 1, "ds_tcn") > fm.SMEM_LIMIT
    assert plan["smem"] == fm.mdtc_smem_bytes(
        2048, c, 8, EIGHT_LAYER_PAD, n, rpt, splits, window, plan["nbuf"],
        "ds_tcn") <= fm.SMEM_LIMIT
    if window == "taps":
        assert plan["smem"] == fm.mdtc_smem_bytes(
            2048, c, 8, 0, n, rpt, splits, "taps", plan["nbuf"], "ds_tcn")


def test_ds_tcn_smem_bytes_mirror_the_layout():
    """The DS-TCN layer's ``Layout``: a weight buffer of one C x C W, 8
    taps and two biases (C <= 128); at C=256 a buffer of taps and
    biases, a ring of two 32-row slices of W and four mbarriers."""
    # hey_snips offline: two buffers, two windows of 56 halo + 33 rows,
    # a 48-row tile at row stride 68, two mbarriers
    assert fm.mdtc_smem_bytes(198, 64, 8, 56, 6, 3, 1, "smem", 2,
                              "ds_tcn") == 4 * (
        2 * (64 * 64 + 10 * 64) + 2 * (56 + 33) * 64 + 48 * 68 + 4)
    # the engine's step at C=48: 10-row tiles (10 groups of 24 threads)
    assert fm.mdtc_smem_bytes(8, 48, 8, 56, 1, 1, 2, "smem", 2,
                              "ds_tcn") == 4 * (
        2 * (48 * 48 + 10 * 48) + 2 * (56 + 8) * 48 + 10 * 52 + 4)
    # hi_xiaowen offline: taps and biases twice, the ring, one staged
    # window of 56 + 36 rows, a 36-row tile, four mbarriers
    assert fm.mdtc_smem_bytes(198, 256, 8, 56, 6, 9, 1, "staged", 2,
                              "ds_tcn") == 4 * (
        2 * 10 * 256 + 2 * 32 * 256 + (56 + 36) * 256 + 36 * 260 + 8)
    assert fm.weight_floats("ds_tcn", 256, 8) == (10 * 256, 2 * 32 * 256)
    assert fm.weight_floats("ds_tcn", 128, 8) == (128 * 128 + 10 * 128, 0)
    assert fm.weight_floats("mdtc", 64, 5) == (2 * 64 * 64 + 8 * 64, 0)


@pytest.mark.parametrize("c,splits,groups,idle", [
    (48, 1, 21, 4), (48, 2, 10, 16), (32, 1, 32, 0), (64, 2, 8, 0),
    (256, 1, 4, 0), (256, 2, 2, 0),
])
def test_thread_map_idle_threads(c, splits, groups, idle):
    """256 threads as C/4 channel quads x row groups x splits: at C=48
    the quads do not divide the block, and the threads past the map (4,
    or 16 with the depth split) own no quad; the other widths use all."""
    assert fm.row_groups(c, splits) == groups
    assert fm.THREADS - groups * splits * (c // 4) == idle
    rows = groups * 2 if splits == 1 else 1
    rpt, got_splits = fm.thread_map(rows, c, "ds_tcn")
    assert (rpt, got_splits) == ((2, 1) if splits == 1 else (1, 2))


def test_wide_sub_tiles_only_where_w_is_sliced():
    """Up to 9 rows a thread where W streams in slices (DS-TCN at 256),
    so that one sub-tile covers a block's 33 frames; 4 elsewhere."""
    assert fm.thread_map(33, 256, "ds_tcn") == (9, 1)
    assert fm.thread_map(29, 256, "ds_tcn") == (8, 1)
    assert fm.thread_map(33, 64, "ds_tcn") == (3, 1)
    assert fm.thread_map(200, 128, "ds_tcn") == (4, 1)
    assert fm.thread_map(200, 256, "ds_tcn") == (9, 1)
    assert fm.sliced("ds_tcn", 256) and not fm.sliced("mdtc", 256)
    assert not fm.sliced("ds_tcn", 128)


def test_plan_raises_where_nothing_fits():
    """At K <= 8 (the wrapper's limit) the taps window always fits; 40
    taps of a halo no staged window holds at C=256 fit nothing, and the
    plan raises (the wrapper asks it before any launch)."""
    assert fm.mdtc_plan(1, 64, 256, 8, 40000, arch="ds_tcn")["window"] == \
        "taps"
    with pytest.raises(ValueError, match="no ds_tcn kernel plan"):
        fm.mdtc_plan(1, 64, 256, 40, 40000, arch="ds_tcn")
