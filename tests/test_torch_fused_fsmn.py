"""Port fused FSMN (ops/fused_fsmn.py plain version, ops/serving.py
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
from wekws_tpu.ops.fused_fsmn import extract_fsmn_weights as jax_extract
from wekws_tpu.ops.fused_fsmn import fused_fsmn_forward as jax_fsmn_forward
from wekws_tpu.ops.fused_fsmn import fused_fsmn_layers as jax_fsmn_layers
from wekws_tpu.ops.serving import build_fused_forward as jax_build_forward
from wekws_tpu.ops.serving import build_fused_stream as jax_build_stream
from wekws_tpu_torch.ops.fused_fsmn import (
    extract_fsmn_weights,
    fused_fsmn_forward,
    fused_fsmn_layers,
    fused_fsmn_layers_plain,
    init_fsmn_cache,
)
from wekws_tpu_torch.ops.serving import build_fused_forward, build_fused_stream
from wekws_tpu_torch.tools.from_jax import model_from_jax

# the JAX suite's own bound for its fused kernels against flax
ATOL, RTOL = 2e-4, 1e-3
IDIM, ODIM = 20, 8


def _conf(rorder=2, lstride=1, rstride=1):
    return {
        "input_dim": IDIM, "output_dim": ODIM, "hidden_dim": 40,
        "preprocessing": {"type": "none"},
        "backbone": {"type": "fsmn", "input_affine_dim": 24,
                     "num_layers": 3, "linear_dim": 40, "proj_dim": 16,
                     "left_order": 5, "right_order": rorder,
                     "left_stride": lstride, "right_stride": rstride,
                     "output_affine_dim": 24},
        "classifier": {"type": "identity", "dropout": 0.0},
        "activation": {"type": "identity"},
    }


def _jax_and_port(conf, seed=0):
    model = jax_init_model(conf)
    variables = model.init(jax.random.PRNGKey(seed),
                           np.zeros((1, 8, IDIM), np.float32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return model, {"params": params}, model_from_jax(params, None, conf)


@pytest.mark.parametrize("rorder,lstride", [(2, 1), (0, 1), (2, 2)])
def test_extract_weights_equal_jax(rorder, lstride):
    """Thirteen tensors, the dummy ``wr`` row of ``rorder == 0`` too."""
    jmodel, variables, pmodel = _jax_and_port(_conf(rorder, lstride))
    want = jax_extract(jmodel.backbone, variables["params"]["backbone"])
    got = extract_fsmn_weights(pmodel.backbone)
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("rorder,lstride,rstride,t", [
    (2, 1, 1, 30), (0, 1, 1, 30), (2, 2, 2, 30), (2, 1, 1, 4), (2, 2, 2, 1),
])
def test_plain_matches_pallas_interpret(rng, rorder, lstride, rstride, t):
    """Layer chain from a random carried cache against the Pallas kernel
    in interpret mode: outputs and new cache.  T = 4 and 1 are shorter
    than P (6 and 12), where the new cache mixes old cache rows and new
    frames."""
    conf = _conf(rorder, lstride, rstride)
    _, _, pmodel = _jax_and_port(conf, seed=1)
    w = extract_fsmn_weights(pmodel.backbone)[4:9]
    pad = 4 * lstride + rorder * rstride
    x = rng.standard_normal((3, t, 40)).astype(np.float32)
    cache = rng.standard_normal((3, 3, pad, 16)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_y, want_c = jax_fsmn_layers(
            jnp.asarray(x), jnp.asarray(cache),
            *[jnp.asarray(a.numpy()) for a in w], 5, rorder, lstride,
            rstride)
    before = fused_fsmn_layers.launches
    got_y, got_c = fused_fsmn_layers(
        torch.from_numpy(x), torch.from_numpy(cache), *w, 5, rorder, lstride,
        rstride)
    assert fused_fsmn_layers.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=ATOL,
                               rtol=RTOL)


def test_fused_forward_chunked_equals_whole_and_jax(rng):
    """``fused_fsmn_forward`` (in/out linears around the chain) whole and
    in 8-frame chunks, against JAX's in interpret mode."""
    jmodel, variables, pmodel = _jax_and_port(_conf(), seed=2)
    x = rng.standard_normal((2, 32, IDIM)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, want_c = jax_fsmn_forward(
            jmodel.backbone, variables["params"]["backbone"], jnp.asarray(x))
    xt = torch.from_numpy(x)
    full, full_c = fused_fsmn_forward(pmodel.backbone, xt)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(full_c.numpy(), np.asarray(want_c), atol=ATOL,
                               rtol=RTOL)
    cache, outs = None, []
    for s in range(0, 32, 8):
        y, cache = fused_fsmn_forward(pmodel.backbone, xt[:, s:s + 8], cache)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(cache, full_c, atol=1e-5, rtol=1e-5)


def test_fused_forward_and_stream_match_jax(rng):
    """FSMN with no preprocessing, identity head and the engine's
    softmax: fused forward and 8-frame stream against JAX's (in interpret
    mode) and against the module forward."""
    conf = _conf()
    jmodel, variables, pmodel = _jax_and_port(conf, seed=3)
    x = rng.standard_normal((2, 32, IDIM)).astype(np.float32)
    lengths = np.asarray([32, 20])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_build_forward(jmodel, variables, softmax=True)(
            jnp.asarray(x), jnp.asarray(lengths)))
        jstep, jinit = jax_build_stream(jmodel, variables, softmax=True)
        jcache, jouts = jinit(2), []
        for s in range(0, 32, 8):
            y, jcache = jstep(jnp.asarray(x[:, s:s + 8]), jcache)
            jouts.append(np.asarray(y))
    got = build_fused_forward(pmodel, softmax=True, device="cpu")(x, lengths)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    with torch.inference_mode():
        module, _ = pmodel(torch.from_numpy(x),
                           lengths=torch.from_numpy(lengths), softmax=True)
    np.testing.assert_allclose(got.numpy(), module.numpy(), atol=1e-5,
                               rtol=1e-5)
    step, init_cache = build_fused_stream(pmodel, softmax=True, device="cpu")
    cache, outs = init_cache(2), []
    assert tuple(cache.shape) == tuple(jcache.shape) == (3, 2, 6, 16)
    for s in range(0, 32, 8):
        y, cache = step(x[:, s:s + 8], cache)
        outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1),
                               np.concatenate(jouts, axis=1), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), atol=ATOL,
                               rtol=RTOL)


def test_wrapper_checks_its_inputs():
    _, _, pmodel = _jax_and_port(_conf())
    w = extract_fsmn_weights(pmodel.backbone)[4:9]
    x = torch.zeros((2, 8, 40))
    with pytest.raises(ValueError, match="cache"):
        fused_fsmn_layers(x, init_fsmn_cache(3, 2, 5, 16), *w, 5, 2)
    with pytest.raises(ValueError, match="proj_w"):
        fused_fsmn_layers(torch.zeros((2, 8, 41)),
                          init_fsmn_cache(3, 2, 6, 16), *w, 5, 2)
    y, c = fused_fsmn_layers_plain(x, init_fsmn_cache(3, 2, 6, 16), *w, 5, 2)
    assert y.shape == (2, 8, 40) and c.shape == (3, 2, 6, 16)
