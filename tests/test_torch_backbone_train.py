"""``Trainer`` step 0 of the other backbones (ROADMAP A.7) against the
JAX package on the CPU: a GRU, ``cnn1d_s1`` preprocessing and a
full-conv TCN wake-word model (tests/test_torch_gru.py's configs) with
the same weights and batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_gru import _conf, _jax_and_port
from wekws_tpu.data.device_pipeline import (
    DeviceFeaturePipeline as JaxPipeline,
)
from wekws_tpu.losses import criterion as jax_criterion
from wekws_tpu_torch.data import DeviceFeaturePipeline
from wekws_tpu_torch.tools.from_jax import grads_from_jax, model_from_jax
from wekws_tpu_torch.train import Trainer

DATASET_CONF = {
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 20, "frame_shift": 10,
                   "frame_length": 25, "dither": 0.0},
}


def _batch(seed=3, b=6, n=4800):
    """Keyword rows carry a 600 Hz tone in noise, one row padded."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    waves = (rng.standard_normal((b, n)) * 300).astype(np.float32)
    waves[::2] += (4000 * np.sin(2 * np.pi * 600 * t)).astype(np.float32)
    lengths = np.full((b,), n, np.int32)
    lengths[-1] = n - 1600
    waves[-1, lengths[-1]:] = 0.0
    return {"waves": waves, "wave_lengths": lengths,
            "target": (np.arange(b) % 2 - 1).astype(np.int32),
            "target_lengths": np.ones((b,), np.int32)}


@pytest.mark.parametrize("kind", ["gru", "cnn1d_s1", "tcn"])
def test_trainer_step0_matches_eager_jax(kind):
    """``Trainer(..., "max_pooling")`` step 0 on the same weights and
    batch (no dither) against JAX: loss 1e-5 rel, every gradient
    within 1e-4 of max(1, its tensor's largest |grad|)
    (tests/test_torch_training.py's bounds), and each BatchNorm's
    running statistics after the step within 1e-5 of JAX's updated
    ``batch_stats`` (flax's momentum 0.9 is torch's 0.1).  A model with
    BatchNorm is held against eager JAX (its jitted CPU gradients are
    up to 3e-3 off its eager ones); the GRU, which has none, against
    jitted JAX, as tests/test_torch_ctc_train.py holds FSMN-CTC."""
    conf = _conf(kind)
    batch = _batch()
    cvp = JaxPipeline.from_conf(DATASET_CONF, training=False)
    feats, fl = cvp(jnp.asarray(batch["waves"]),
                    jnp.asarray(batch["wave_lengths"]))
    conf["cmvn"] = {"mean": np.asarray(feats.mean(axis=(0, 1))).tolist(),
                    "istd": np.asarray(1.0 / (feats.std(axis=(0, 1))
                                              + 1e-6)).tolist(),
                    "norm_var": True}
    jmodel, variables, model = _jax_and_port(conf, seed=4)

    def loss(params):
        (probs, _), upd = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            feats, lengths=fl, train=True, mutable=["batch_stats"])
        return jax_criterion("max_pooling", probs,
                             jnp.asarray(batch["target"]), fl, None,
                             5)[0], upd.get("batch_stats", {})

    value_and_grad = jax.value_and_grad(loss, has_aux=True)
    if kind == "gru":
        (loss0, stats1), grads0 = jax.jit(value_and_grad)(
            variables["params"])
    else:
        with jax.disable_jit():
            (loss0, stats1), grads0 = value_and_grad(variables["params"])
    trainer = Trainer(model, DeviceFeaturePipeline.from_conf(DATASET_CONF),
                      DeviceFeaturePipeline.from_conf(DATASET_CONF,
                                                      training=False),
                      "max_pooling", grad_clip=5.0, min_duration=5,
                      device="cpu")
    state = trainer.init_state()
    got, _ = trainer.loss_and_grads(state, batch, seed=0)
    np.testing.assert_allclose(float(got), float(loss0), rtol=1e-5)
    want = grads_from_jax(jax.device_get(grads0), conf)
    named = dict(state.model.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        scale = max(float(g.abs().max()), 1.0)
        err = float((named[name].grad - g).abs().max())
        assert err <= 1e-4 * scale, f"{name}: {err} vs {scale}"
    after = model_from_jax(variables["params"], jax.device_get(stats1),
                           conf).state_dict()
    running = [n for n, _ in state.model.named_buffers() if "running" in n]
    assert bool(running) == (kind != "gru")
    buffers = dict(state.model.named_buffers())
    for name in running:
        np.testing.assert_allclose(buffers[name].numpy(),
                                   after[name].numpy(), atol=1e-5,
                                   rtol=1e-5)
