"""Port TCN / DS-TCN (wekws_tpu_torch.models.tcn) against the flax
module on the same weights, bridged by wekws_tpu_torch.tools.from_jax:
eval forward, chunked streaming and one training forward + gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu_torch.models.tcn import TCN, CnnBlock, DsCnnBlock
from wekws_tpu_torch.tools.from_jax import grads_from_jax, model_from_jax

HDIM = 16


def _conf(ds, kernel_size=4):
    """No preprocessing and an identity head, so the model's output is
    the backbone's."""
    return {
        "input_dim": HDIM, "output_dim": HDIM, "hidden_dim": HDIM,
        "preprocessing": {"type": "none"},
        "backbone": {"type": "tcn", "ds": ds, "num_layers": 3,
                     "kernel_size": kernel_size, "dropout": 0.0},
        "classifier": {"type": "identity", "dropout": 0.0},
        "activation": {"type": "identity"},
    }


def _jax_and_port(conf, seed=0):
    """Flax model + variables with perturbed BN statistics, and the port
    model holding the same weights."""
    model = jax_init_model(conf)
    x0 = np.zeros((1, 8, conf["input_dim"]), np.float32)
    variables = model.init(jax.random.PRNGKey(seed), x0)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * np.arange(a.size, dtype=np.float32)
        .reshape(a.shape) / max(a.size, 1),
        variables["batch_stats"],
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return model, {"params": params, "batch_stats": stats}, model_from_jax(
        params, stats, conf)


@pytest.mark.parametrize("ds", [True, False])
def test_eval_forward_matches_flax(rng, ds):
    """Same float32 arithmetic in another order: 1e-5 abs + 1e-5 rel."""
    conf = _conf(ds)
    jmodel, variables, pmodel = _jax_and_port(conf)
    assert isinstance(pmodel.backbone, TCN)
    assert isinstance(pmodel.backbone.network[0],
                      DsCnnBlock if ds else CnnBlock)
    x = rng.standard_normal((3, 40, HDIM)).astype(np.float32)
    want, _ = jmodel.apply(variables, x)
    with torch.inference_mode():
        got, _ = pmodel(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert pmodel.backbone.padding == jmodel.backbone.padding == 3 * 7


@pytest.mark.parametrize("ds", [True, False])
def test_chunked_streaming_matches_flax_and_full(rng, ds):
    """8-frame chunks with the carried cache: outputs and final caches
    against flax (1e-5), and against the port's own whole-utterance
    forward (chunked == whole)."""
    conf = _conf(ds)
    jmodel, variables, pmodel = _jax_and_port(conf, seed=1)
    x = rng.standard_normal((2, 40, HDIM)).astype(np.float32)
    jcache, pcache = jmodel.init_cache(2), pmodel.init_cache(2)
    assert [tuple(c.shape) for c in pcache] == [c.shape for c in jcache]
    jouts, pouts = [], []
    with torch.inference_mode():
        for s in range(0, 40, 8):
            y, jcache = jmodel.apply(variables, x[:, s:s + 8], jcache)
            jouts.append(np.asarray(y))
            y, pcache = pmodel(torch.from_numpy(x[:, s:s + 8]), pcache)
            pouts.append(y.numpy())
        full, _ = pmodel(torch.from_numpy(x))
    streamed = np.concatenate(pouts, axis=1)
    np.testing.assert_allclose(streamed, np.concatenate(jouts, axis=1),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(streamed, full.numpy(), atol=1e-5, rtol=1e-5)
    for pc, jc in zip(pcache, jcache):
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("ds", [True, False])
def test_train_forward_and_gradients_match_eager_flax(rng, ds):
    """Training mode (batch statistics, dropout 0): output 1e-5, every
    parameter gradient within 1e-4 of the largest |grad|, against eager
    JAX (its jitted CPU program itself differs from its eager ops by more
    than that), and the updated running statistics 1e-5."""
    conf = _conf(ds)
    jmodel, variables, pmodel = _jax_and_port(conf, seed=2)
    x = rng.standard_normal((4, 24, HDIM)).astype(np.float32)
    co = rng.standard_normal((4, 24, HDIM)).astype(np.float32)

    def loss(params):
        (y, _), upd = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(y * co), (y, upd["batch_stats"])

    with jax.disable_jit():
        (_, (want_y, want_stats)), grads = jax.value_and_grad(
            loss, has_aux=True)(variables["params"])
    pmodel.train()
    got_y, _ = pmodel(torch.from_numpy(x))
    (got_y * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(want_y),
                               atol=1e-5, rtol=1e-5)
    want = grads_from_jax(jax.device_get(grads), conf)
    named = dict(pmodel.named_parameters())
    assert set(want) == set(named)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        err = float((named[name].grad - g).abs().max())
        assert err <= 1e-4 * scale, f"{name}: {err} vs {scale}"
    after = model_from_jax(variables["params"], jax.device_get(want_stats),
                           conf).state_dict()
    for name, buf in pmodel.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), after[name].numpy(),
                                       atol=1e-5, rtol=1e-5)
