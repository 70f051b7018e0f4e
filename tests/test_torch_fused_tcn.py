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


def _conf(ds=True, backbone=None):
    return {
        "input_dim": 40, "output_dim": 2, "hidden_dim": 32,
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
    a DS-TCN without linear preprocessing neither.  The GRU is not
    ported: ``init_model`` raises, and so would the dispatch."""
    from wekws_tpu_torch.models import init_model

    conf = _conf(ds=False)
    jmodel, variables, pmodel = _jax_and_port(conf)
    assert jax_build_forward(jmodel, variables) is None
    assert build_fused_forward(pmodel, device="cpu") is None
    assert build_fused_stream(pmodel, device="cpu") is None
    conf = dict(_conf(), input_dim=32, preprocessing={"type": "none"})
    assert build_fused_forward(init_model(conf), device="cpu") is None
    with pytest.raises(NotImplementedError, match="gru"):
        init_model(_conf(backbone={"type": "gru", "num_layers": 1}))
    pmodel.backbone = torch.nn.GRU(32, 32)
    with pytest.raises(NotImplementedError, match="GRU"):
        build_fused_forward(pmodel, device="cpu")


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
