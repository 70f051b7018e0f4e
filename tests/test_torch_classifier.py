"""The port's CE heads (GlobalClassifier, LastClassifier) against flax's,
the CE loss and its gradients through them against eager JAX, the
heads wired through ``init_model`` and ``tools/from_jax``, and the
port's initial draw (flax's truncated lecun normal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wekws_tpu.losses import criterion as jax_criterion
from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.models.classifier import GlobalClassifier as JaxGlobal
from wekws_tpu.models.classifier import LastClassifier as JaxLast
from wekws_tpu_torch.losses import criterion
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.models.classifier import GlobalClassifier, LastClassifier
from wekws_tpu_torch.models.kws_model import truncated_lecun_normal
from wekws_tpu_torch.tools.from_jax import model_from_jax

B, T, H, K = 5, 11, 16, 3
HEADS = {"global": (JaxGlobal, GlobalClassifier),
         "last": (JaxLast, LastClassifier)}


def head_pair(kind):
    """flax head with seeded params and the port head holding them."""
    jax_cls, cls = HEADS[kind]
    jhead = jax_cls(K, dropout=0.1)
    params = jhead.init(jax.random.PRNGKey(3), jnp.zeros((B, T, H)))
    head = cls(H, K, dropout=0.1).eval()
    mlp = params["params"]["mlp"]
    with torch.no_grad():
        for idx, name in ((0, "fc1"), (3, "fc2")):
            head.classifier[idx].weight.copy_(
                torch.from_numpy(np.array(mlp[name]["kernel"]).T))
            head.classifier[idx].bias.copy_(
                torch.from_numpy(np.array(mlp[name]["bias"])))
    return jhead, params, head


def inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    lengths = np.array([11, 7, 1, 0, 4], np.int32)  # 0: divide by 1, frame 0
    target = np.array([0, 2, 1, 1, 0], np.int32)
    return x, lengths, target


@pytest.mark.parametrize("use_lengths", [True, False])
@pytest.mark.parametrize("kind", ["global", "last"])
def test_head_matches_flax(kind, use_lengths):
    jhead, params, head = head_pair(kind)
    x, lengths, _ = inputs()
    jl = jnp.asarray(lengths) if use_lengths else None
    tl = torch.from_numpy(lengths) if use_lengths else None
    want = np.asarray(jhead.apply(params, jnp.asarray(x), lengths=jl))
    got = head(torch.from_numpy(x), tl).detach().numpy()
    assert got.shape == (B, K)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["global", "last"])
def test_ce_loss_and_grads_match_eager_jax(kind):
    """CE over the head's logits: loss 1e-6 rel, the gradients of the
    head's weights and of its input 1e-6 abs (tests/test_torch_losses.py)."""
    jhead, params, head = head_pair(kind)
    x, lengths, target = inputs()
    valid = np.array([1, 1, 1, 0, 1], np.float32)

    def loss_fn(p, xx):
        logits = jhead.apply(p, xx, lengths=jnp.asarray(lengths))
        return jax_criterion("ce", logits, jnp.asarray(target),
                             jnp.asarray(lengths), None, 0,
                             valid=jnp.asarray(valid))[0]

    with jax.disable_jit():
        want, (gp, gx) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    logits = head(tx, torch.from_numpy(lengths))
    loss, _ = criterion("ce", logits, torch.from_numpy(target).long(),
                        torch.from_numpy(lengths), None, 0,
                        valid=torch.from_numpy(valid))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-6)
    mlp = gp["params"]["mlp"]
    for idx, name in ((0, "fc1"), (3, "fc2")):
        np.testing.assert_allclose(head.classifier[idx].weight.grad.numpy(),
                                   np.asarray(mlp[name]["kernel"]).T,
                                   atol=1e-6)
        np.testing.assert_allclose(head.classifier[idx].bias.grad.numpy(),
                                   np.asarray(mlp[name]["bias"]), atol=1e-6)


@pytest.mark.parametrize("kind", ["global", "last"])
def test_ce_model_through_init_model_and_from_jax(kind):
    """A DS-TCN CE model built by both packages' init_model, the JAX
    weights bridged: eval-mode logits (B, K) within 1e-5."""
    conf = {"input_dim": 20, "output_dim": K, "hidden_dim": H,
            "preprocessing": {"type": "linear"},
            "backbone": {"type": "tcn", "ds": True, "num_layers": 2,
                         "kernel_size": 3, "dropout": 0.1},
            "classifier": {"type": kind, "dropout": 0.1}}
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((B, T, 20)).astype(np.float32)
    lengths = np.array([11, 9, 5, 3, 1], np.int32)
    jmodel = jax_init_model(conf)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats))
    want, _ = jmodel.apply(variables, jnp.asarray(feats),
                           lengths=jnp.asarray(lengths))
    model = model_from_jax(variables["params"],
                           variables.get("batch_stats", {}), conf)
    assert type(model.classifier) is HEADS[kind][1]
    with torch.no_grad():
        got, _ = model(torch.from_numpy(feats),
                       lengths=torch.from_numpy(lengths))
    assert got.shape == (B, K) and model.activation == "identity"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert init_model(conf).classifier.classifier[3].out_features == K


def test_init_draw_is_truncated_lecun_normal():
    """flax's lecun_normal: inside +-2 sigma of N(0, 1) before scaling,
    variance 1/fan_in within 3% over a 64 x 64 x 64 draw."""
    fan_in = 64
    w = truncated_lecun_normal((64, 64, 64), fan_in,
                               torch.Generator().manual_seed(0))
    sigma = 1.0 / (0.87962566103423978 * np.sqrt(fan_in))
    assert w.dtype == torch.float32
    assert float(w.abs().max()) <= 2.0 * sigma * (1 + 1e-6)
    assert abs(float(w.double().var()) * fan_in - 1.0) < 0.03
    assert abs(float(w.double().mean())) < 3e-3
    model = init_model({"input_dim": 10, "output_dim": 1, "hidden_dim": 8,
                        "preprocessing": {"type": "linear"},
                        "backbone": {"type": "mdtc", "num_stack": 1,
                                     "stack_size": 1, "kernel_size": 3,
                                     "hidden_dim": 8, "causal": True}})
    head = model.classifier.linear.weight.detach()
    assert float(head.abs().max()) <= 2.0 / (0.8796 * np.sqrt(8))
