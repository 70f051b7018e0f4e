"""Port FSMN (wekws_tpu_torch.models.fsmn) against the flax module on
the same weights, bridged by wekws_tpu_torch.tools.from_jax: whole
utterance, chunked streaming and gradients; the Kaldi nnet1 text of
wekws_tpu_torch.models.fsmn_kaldi against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.models.fsmn_kaldi import fsmn_to_kaldi as jax_fsmn_to_kaldi
from wekws_tpu_torch.models.fsmn import FSMN
from wekws_tpu_torch.models.fsmn_kaldi import fsmn_from_kaldi, fsmn_to_kaldi
from wekws_tpu_torch.tools.from_jax import grads_from_jax, model_from_jax

IDIM, ODIM = 20, 8


def _conf(rorder, lstride):
    return {
        "input_dim": IDIM, "output_dim": ODIM, "hidden_dim": 40,
        "preprocessing": {"type": "none"},
        "backbone": {"type": "fsmn", "input_affine_dim": 24,
                     "num_layers": 3, "linear_dim": 40, "proj_dim": 16,
                     "left_order": 5, "right_order": rorder,
                     "left_stride": lstride, "right_stride": 1,
                     "output_affine_dim": 24},
        "classifier": {"type": "identity", "dropout": 0.0},
        "activation": {"type": "identity"},
    }


def _jax_and_port(conf, seed=0):
    model = jax_init_model(conf)
    x0 = np.zeros((1, 8, IDIM), np.float32)
    variables = model.init(jax.random.PRNGKey(seed), x0)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return model, {"params": params}, model_from_jax(params, None, conf)


@pytest.mark.parametrize("rorder,lstride", [(2, 1), (0, 1), (2, 2)])
def test_whole_and_chunked_match_flax(rng, rorder, lstride):
    """Whole utterance and 8-frame chunks with the carried cache against
    flax, outputs and final caches (1e-5: float32, another order), and
    chunked == whole in the port.  With ``rorder`` > 0 the output is the
    delayed one on both sides."""
    conf = _conf(rorder, lstride)
    jmodel, variables, pmodel = _jax_and_port(conf, seed=rorder + lstride)
    assert isinstance(pmodel.backbone, FSMN)
    assert (pmodel.backbone.layer_padding == jmodel.backbone.layer_padding
            == 4 * lstride + rorder)
    x = rng.standard_normal((2, 32, IDIM)).astype(np.float32)
    want, _ = jmodel.apply(variables, x)
    jcache, pcache = jmodel.init_cache(2), pmodel.init_cache(2)
    jouts, pouts = [], []
    with torch.inference_mode():
        full, _ = pmodel(torch.from_numpy(x))
        for s in range(0, 32, 8):
            y, jcache = jmodel.apply(variables, x[:, s:s + 8], jcache)
            jouts.append(np.asarray(y))
            y, pcache = pmodel(torch.from_numpy(x[:, s:s + 8]), pcache)
            pouts.append(y.numpy())
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    streamed = np.concatenate(pouts, axis=1)
    np.testing.assert_allclose(streamed, np.concatenate(jouts, axis=1),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(streamed, full.numpy(), atol=1e-5, rtol=1e-5)
    for pc, jc in zip(pcache, jcache):
        assert tuple(pc.shape) == jc.shape
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-5,
                                   rtol=1e-5)


def test_gradients_match_eager_flax(rng):
    """Every parameter gradient within 1e-4 of the largest |grad|,
    against eager JAX."""
    conf = _conf(2, 2)
    jmodel, variables, pmodel = _jax_and_port(conf, seed=5)
    x = rng.standard_normal((3, 20, IDIM)).astype(np.float32)
    co = rng.standard_normal((3, 20, ODIM)).astype(np.float32)

    def loss(params):
        y, _ = jmodel.apply({"params": params}, jnp.asarray(x), train=True)
        return jnp.sum(y * co)

    with jax.disable_jit():
        grads = jax.grad(loss)(variables["params"])
    pmodel.train()
    y, _ = pmodel(torch.from_numpy(x))
    (y * torch.from_numpy(co)).sum().backward()
    want = grads_from_jax(jax.device_get(grads), conf)
    named = dict(pmodel.named_parameters())
    assert set(want) == set(named)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        err = float((named[name].grad - g).abs().max())
        assert err <= 1e-4 * scale, f"{name}: {err} vs {scale}"


@pytest.mark.parametrize("rorder,lstride", [(2, 1), (0, 2)])
def test_kaldi_text_equals_jax_and_round_trips(rng, rorder, lstride):
    """For the same weights ``fsmn_to_kaldi`` writes the JAX package's
    text byte for byte; text -> weights -> text is the identity, and
    weights -> text -> weights keeps the 7 printed digits (within 6e-7
    of each value), so the restored model's output stays within 1e-5
    of the original's."""
    conf = _conf(rorder, lstride)
    jmodel, variables, pmodel = _jax_and_port(conf, seed=5)
    fsmn = pmodel.backbone
    text = fsmn_to_kaldi(fsmn, fsmn.state_dict())
    assert text == jax_fsmn_to_kaldi(jmodel.backbone,
                                     variables["params"]["backbone"])
    assert text.startswith("<Nnet>") and text.count("<Fsmn>") == 3
    restored = fsmn_from_kaldi(fsmn, text)
    assert set(restored) == set(fsmn.state_dict())
    for name, want in fsmn.state_dict().items():
        assert restored[name].shape == want.shape
        np.testing.assert_allclose(restored[name].numpy(), want.numpy(),
                                   rtol=6e-7, atol=1e-12)
    assert fsmn_to_kaldi(fsmn, restored) == text
    back = FSMN(IDIM, 24, 3, 40, 16, 5, rorder, lstride, 1, 24, ODIM)
    back.load_state_dict(restored)
    x = torch.from_numpy(rng.standard_normal((2, 20, IDIM)).astype(
        np.float32))
    with torch.inference_mode():
        want, _ = fsmn(x)
        got, _ = back(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
