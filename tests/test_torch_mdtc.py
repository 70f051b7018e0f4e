"""Port MDTC KWSModel against the flax model on the same weights
(bridged by wekws_tpu_torch.tools.from_jax), plus BN folding."""

import jax
import numpy as np
import pytest
import torch

from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.ops import extract_mdtc_weights as jax_extract_mdtc_weights
from wekws_tpu.ops.fused_common import fold_bn as jax_fold_bn
from wekws_tpu_torch.ops.fused_common import fold_bn
from wekws_tpu_torch.ops.fused_mdtc import extract_mdtc_weights
from wekws_tpu_torch.tools.from_jax import model_from_jax


def _model_conf(rng, idim=23, hdim=32, head=None):
    conf = {
        "input_dim": idim, "output_dim": 2, "hidden_dim": hdim,
        "preprocessing": {"type": "linear"},
        "backbone": {"type": "mdtc", "num_stack": 2, "stack_size": 3,
                     "kernel_size": 5, "hidden_dim": hdim, "causal": True},
        "cmvn": {"mean": rng.standard_normal(idim).tolist(),
                 "istd": (0.5 + rng.random(idim)).tolist(),
                 "norm_var": True},
    }
    if head is not None:
        conf["classifier"] = {"type": head, "dropout": 0.0}
    return conf


def _jax_and_port(conf, seed=0):
    """Flax model + variables (BN stats nudged so folding is not the
    identity) and the port model holding the same weights."""
    model = jax_init_model(conf)
    x0 = np.zeros((1, 8, conf["input_dim"]), np.float32)
    variables = model.init(jax.random.PRNGKey(seed), x0)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * np.arange(a.size, dtype=np.float32)
        .reshape(a.shape) / max(a.size, 1),
        variables["batch_stats"],
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    variables = {"params": params, "batch_stats": stats}
    return model, variables, model_from_jax(params, stats, conf)


@pytest.mark.parametrize("head", [None, "element"])
def test_whole_utterance_matches_flax(rng, head):
    conf = _model_conf(rng, head=head)
    jmodel, variables, pmodel = _jax_and_port(conf)
    x = rng.standard_normal((3, 40, 23)).astype(np.float32)
    lengths = np.asarray([40, 25, 7], np.int32)
    want, _ = jmodel.apply(variables, x, lengths=lengths)
    with torch.inference_mode():
        got, _ = pmodel(torch.from_numpy(x),
                        lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)


def test_chunked_with_cache_matches_flax_and_full(rng):
    conf = _model_conf(rng)
    jmodel, variables, pmodel = _jax_and_port(conf, seed=1)
    x = rng.standard_normal((2, 48, 23)).astype(np.float32)
    jcache = jmodel.init_cache(2)
    pcache = pmodel.init_cache(2)
    jouts, pouts = [], []
    with torch.inference_mode():
        for s in range(0, 48, 12):
            y, jcache = jmodel.apply(variables, x[:, s:s + 12], jcache)
            jouts.append(np.asarray(y))
            y, pcache = pmodel(torch.from_numpy(x[:, s:s + 12]), pcache)
            pouts.append(y.numpy())
        full, _ = pmodel(torch.from_numpy(x))
    streamed = np.concatenate(pouts, axis=1)
    np.testing.assert_allclose(streamed, np.concatenate(jouts, axis=1),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(streamed, full.numpy(), atol=1e-5,
                               rtol=1e-5)
    for pc, jc in zip(pcache, jcache):
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=2e-4,
                                   rtol=1e-3)


def test_fold_bn_equals_jax(rng):
    w = rng.standard_normal((5, 32)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    gamma, beta, mean = (rng.standard_normal(32).astype(np.float32)
                         for _ in range(3))
    var = (0.1 + rng.random(32)).astype(np.float32)
    want = jax_fold_bn(w, b, {"scale": gamma, "bias": beta},
                       {"mean": mean, "var": var})
    got = fold_bn(w, b, gamma, beta, mean, var)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), x)
    want_nb = jax_fold_bn(w, None, {"scale": gamma, "bias": beta},
                          {"mean": mean, "var": var})
    got_nb = fold_bn(w, None, gamma, beta, mean, var)
    np.testing.assert_array_equal(got_nb[1].numpy(), want_nb[1])


def test_extract_mdtc_weights_equals_jax(rng):
    conf = _model_conf(rng)
    jmodel, variables, pmodel = _jax_and_port(conf, seed=2)
    want = jax_extract_mdtc_weights(
        jmodel.backbone, variables["params"]["backbone"],
        variables["batch_stats"]["backbone"],
    )
    got = extract_mdtc_weights(pmodel.backbone)
    assert got[-1] == want[-1]
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unported_configs_raise(rng):
    """The training knobs of ROADMAP A.15, once refused, now build MDTC
    with each knob where the JAX package puts it (the compute dtype on
    the convolutions, ``bn_dtype`` on the BatchNorms, ``remat`` on the
    blocks, ``ghost_bn`` as GhostBatchNorm), float32 parameters; an
    unknown dtype name raises.  The GRU backbone, ``cnn1d_s1``
    preprocessing (A.7) and the CE heads build (a GRU config's bf16
    ``dtype`` trains in float32, as in JAX)."""
    from wekws_tpu_torch.models import GRU, init_model
    from wekws_tpu_torch.models.layers import (
        BatchNorm,
        DepthwiseConv1d,
        GhostBatchNorm,
        PointwiseConv1d,
    )
    from wekws_tpu_torch.models.mdtc import TCNBlock

    from wekws_tpu_torch.models.subsampling import Conv1dSubsampling1

    def built(extra, bextra):
        conf = dict(_model_conf(rng), **extra)
        conf["backbone"] = dict(conf["backbone"], **bextra)
        model = init_model(conf)
        assert all(p.dtype == torch.float32 for p in model.parameters())
        return list(model.backbone.modules())

    mods = built({"dtype": "bfloat16"}, {})
    assert all(m.dtype == torch.bfloat16 for m in mods
               if isinstance(m, (DepthwiseConv1d, PointwiseConv1d)))
    assert all(m.out_dtype is None for m in mods if isinstance(m, BatchNorm))
    assert all(m.remat for m in built({}, {"remat": True})
               if isinstance(m, TCNBlock))
    assert all(m.out_dtype == torch.bfloat16
               for m in built({}, {"bn_dtype": "bfloat16"})
               if isinstance(m, BatchNorm))
    assert all(type(m) is GhostBatchNorm and m.num_groups == 2
               for m in built({}, {"ghost_bn": 2}) if isinstance(m, BatchNorm))
    with pytest.raises(ValueError, match="dtype"):
        built({"dtype": "bfloat17"}, {})
    conf = dict(_model_conf(rng), dtype="bfloat16")
    conf["backbone"] = {"type": "gru", "num_layers": 1}
    assert isinstance(init_model(conf).backbone, GRU)
    conf = _model_conf(rng)
    conf["preprocessing"] = {"type": "cnn1d_s1"}
    assert isinstance(init_model(conf).preprocessing, Conv1dSubsampling1)
    assert type(init_model(_model_conf(rng, head="global")).classifier
                ).__name__ == "GlobalClassifier"
