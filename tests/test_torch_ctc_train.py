"""The port's CTC training (wekws_tpu_torch.train with the ``ctc``
criterion) against the JAX package on the CPU: a small FSMN-CTC model
(2 layers, narrow) on spliced, frame-skipped fbank with the same
weights (bridged by tools/from_jax.py) and the same batch of four
utterances with padded label rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wekws_tpu.data.device_pipeline import (
    DeviceFeaturePipeline as JaxPipeline,
)
from wekws_tpu.decode import acc_utterance as jax_acc_utterance
from wekws_tpu.losses import criterion as jax_criterion
from wekws_tpu.losses import criterion_per_utt as jax_criterion_per_utt
from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu_torch.data import DeviceFeaturePipeline
from wekws_tpu_torch.tools.from_jax import grads_from_jax, model_from_jax
from wekws_tpu_torch.train import Executor, Trainer

VOCAB = 7
DATASET_CONF = {
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 20, "frame_shift": 10,
                   "frame_length": 25, "dither": 0.0},
    "context_expansion": True,
    "context_expansion_conf": {"left": 1, "right": 1},
    "frame_skip": 2,
}


def _batch(seed=0, b=4, n=8000):
    """Tones in noise, one shorter row; labels padded with -1 as the
    data pipeline pads them."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    waves = (rng.standard_normal((b, n)) * 300).astype(np.float32)
    for i in range(b):
        waves[i] += (3000 * np.sin(2 * np.pi * (400 + 150 * i) * t)
                     ).astype(np.float32)
    lengths = np.full((b,), n, np.int32)
    lengths[-1] = n - 2400
    waves[-1, lengths[-1]:] = 0.0
    target = np.full((b, 3), -1, np.int32)
    target_lengths = np.array([3, 2, 3, 1], np.int32)
    for i, u in enumerate(target_lengths):
        target[i, :u] = rng.integers(1, VOCAB, u)
    target[2, 1] = target[2, 0]  # a repeated label
    return {"waves": waves, "wave_lengths": lengths, "target": target,
            "target_lengths": target_lengths}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX model's initial parameters, its step-0 loss and gradients
    (jitted: without the BatchNorm of tests/test_torch_training.py, whose
    jitted CPU gradients differ from the eager ones by up to 3e-3, they
    hold the eager bound), cv per-utterance losses, accuracies and
    log-probs."""
    batch = _batch()
    cvp = JaxPipeline.from_conf(DATASET_CONF, training=False)
    feats, fl = cvp(jnp.asarray(batch["waves"]),
                    jnp.asarray(batch["wave_lengths"]))
    conf = {
        "input_dim": 60, "output_dim": VOCAB, "hidden_dim": 16,
        "preprocessing": {"type": "none"},
        "backbone": {"type": "fsmn", "input_affine_dim": 24,
                     "num_layers": 2, "linear_dim": 20, "proj_dim": 12,
                     "left_order": 3, "right_order": 1, "left_stride": 1,
                     "right_stride": 1, "output_affine_dim": 24},
        "classifier": {"type": "identity", "dropout": 0.1},
        "activation": {"type": "identity"},
        "cmvn": {"mean": np.asarray(feats.mean(axis=(0, 1))).tolist(),
                 "istd": np.asarray(1.0 / (feats.std(axis=(0, 1)) + 1e-6)
                                    ).tolist(),
                 "norm_var": True},
    }
    model = jax_init_model(conf)
    params = model.init(jax.random.PRNGKey(0), feats)["params"]
    target = jnp.asarray(batch["target"])
    target_lengths = jnp.asarray(batch["target_lengths"])

    def loss(pp):
        logits, _ = model.apply({"params": pp}, feats, lengths=fl,
                                train=True)
        return jax_criterion("ctc", logits, target, fl, target_lengths)[0]

    loss0, grads0 = jax.jit(jax.value_and_grad(loss))(params)
    logits, _ = model.apply({"params": params}, feats, lengths=fl)
    loss_b, acc_b = jax.jit(lambda *a: jax_criterion_per_utt("ctc", *a))(
        logits, target, fl, target_lengths)
    log_probs = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    return {"batch": batch, "conf": conf,
            "params": jax.device_get(params), "loss0": float(loss0),
            "grads0": jax.device_get(grads0), "loss_b": np.asarray(loss_b),
            "acc_b": np.asarray(acc_b), "log_probs": log_probs,
            "feat_lengths": np.asarray(fl)}


def _trainer(ref):
    model = model_from_jax(ref["params"], None, ref["conf"])
    return Trainer(model, DeviceFeaturePipeline.from_conf(DATASET_CONF),
                   DeviceFeaturePipeline.from_conf(DATASET_CONF,
                                                   training=False),
                   "ctc", grad_clip=5.0, device="cpu")


def test_step0_loss_and_grads_match_jax(jax_ref):
    """Step 0 on the same weights and batch: loss 1e-5 rel, every
    gradient within 1e-4 of max(1, its tensor's largest |grad|)."""
    trainer = _trainer(jax_ref)
    state = trainer.init_state()
    loss, acc = trainer.loss_and_grads(state, jax_ref["batch"], seed=0)
    np.testing.assert_allclose(float(loss), jax_ref["loss0"], rtol=1e-5)
    assert float(acc) == 0.0
    want = grads_from_jax(jax_ref["grads0"], jax_ref["conf"])
    named = dict(state.model.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        scale = max(float(g.abs().max()), 1.0)
        err = float((named[name].grad - g).abs().max())
        assert err <= 1e-4 * scale, f"{name}: {err} vs {scale}"


def test_cv_outputs_and_decode_acc_match_jax(jax_ref):
    """cv_step_full: per-utterance losses 1e-5 rel, greedy accuracies
    exact, log-probs 1e-5 abs; Executor.cv(decode_acc=True) reports
    acc_utterance of those posteriors as the JAX executor does; three
    train steps keep the loss finite."""
    trainer = _trainer(jax_ref)
    state = trainer.init_state()
    full = trainer.cv_step_full(state, jax_ref["batch"])
    np.testing.assert_allclose(full["loss_b"].numpy(), jax_ref["loss_b"],
                               rtol=1e-5)
    np.testing.assert_array_equal(full["correct_b"].numpy(),
                                  jax_ref["acc_b"])
    np.testing.assert_array_equal(full["feat_lengths"].numpy(),
                                  jax_ref["feat_lengths"])
    np.testing.assert_allclose(full["log_probs"].numpy(),
                               jax_ref["log_probs"], atol=1e-5)
    batch = jax_ref["batch"]
    want_acc = jax_acc_utterance(np.exp(jax_ref["log_probs"]),
                                 batch["target"], jax_ref["feat_lengths"],
                                 batch["target_lengths"])
    result = Executor(trainer).cv(state, [batch], decode_acc=True)
    assert result["cv_decode_acc"] == pytest.approx(want_acc, abs=1e-9)
    np.testing.assert_allclose(result["cv_loss"],
                               jax_ref["loss_b"].mean(), rtol=1e-5)
    plain = Executor(trainer).cv(state, [batch])
    assert "cv_decode_acc" not in plain
    assert plain == {k: v for k, v in result.items() if k != "cv_decode_acc"}
    losses = []
    for _ in range(3):
        state, metrics = trainer.train_step(state, batch, 1, 1e-2)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < jax_ref["loss0"]
