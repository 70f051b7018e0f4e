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
