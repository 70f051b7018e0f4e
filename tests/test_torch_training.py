"""The port's training slice (wekws_tpu_torch.train) against the JAX
package's Trainer on the CPU: the fused MDTC max-pooling model with
the same weights (bridged by tools/from_jax.py) and the same batch."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wekws_tpu.data.device_pipeline import (
    DeviceFeaturePipeline as JaxPipeline,
)
from wekws_tpu.losses import criterion as jax_criterion
from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.parallel import make_mesh, shard_batch
from wekws_tpu.train import Trainer as JaxTrainer
from wekws_tpu.train.steps import make_optimizer as jax_make_optimizer
from wekws_tpu_torch.data import DeviceFeaturePipeline
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.tools.from_jax import grads_from_jax, model_from_jax
from wekws_tpu_torch.train import (
    Executor,
    ReduceLROnPlateau,
    Trainer,
    average_checkpoints,
    link_final,
    load_checkpoint,
    load_checkpoint_info,
    make_optimizer,
    save_checkpoint,
)

LR = 1e-3
DATASET_CONF = {
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 40, "frame_shift": 10,
                   "frame_length": 25, "dither": 0.0},
}
AUG_CONF = {
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 40, "frame_shift": 10,
                   "frame_length": 25, "dither": 1.0, "dither_mode": "wave",
                   "precision": "default"},
    "spec_aug": True,
    "spec_aug_conf": {"num_t_mask": 1, "num_f_mask": 1, "max_t": 20,
                      "max_f": 10},
}


def _batch(seed=0, b=8, n=8000):
    """Keyword rows carry a 500 Hz tone in noise, fillers noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    waves = (rng.standard_normal((b, n)) * 300).astype(np.float32)
    waves[::2] += (4000 * np.sin(2 * np.pi * 500 * t)).astype(np.float32)
    lengths = np.full((b,), n, np.int32)
    lengths[-1] = n - 1600  # one padded row
    waves[-1, lengths[-1]:] = 0.0
    return {"waves": waves, "wave_lengths": lengths,
            "target": (np.arange(b) % 2 - 1).astype(np.int32),
            "target_lengths": np.ones((b,), np.int32)}


def _model_conf(batch):
    feats, _ = JaxPipeline.from_conf(DATASET_CONF, training=False)(
        jnp.asarray(batch["waves"]), jnp.asarray(batch["wave_lengths"]))
    mean = np.asarray(feats.mean(axis=(0, 1)))
    istd = np.asarray(1.0 / (feats.std(axis=(0, 1)) + 1e-6))
    return {
        "input_dim": 40, "output_dim": 1, "hidden_dim": 16,
        "preprocessing": {"type": "linear"},
        "backbone": {"type": "mdtc", "num_stack": 2, "stack_size": 2,
                     "kernel_size": 3, "hidden_dim": 16, "causal": True,
                     "fused_train": True},
        "cmvn": {"mean": mean.tolist(), "istd": istd.tolist(),
                 "norm_var": True},
    }


@pytest.fixture(scope="module")
def jax_run():
    """JAX Trainer (its unfused exact-BN model, whose parity with the
    fused one tests/test_fused_train.py and test_torch_fused_train.py
    pin): initial variables, step-0 loss and gradients, and three train
    steps (losses and parameters after each).

    The step-0 reference runs eagerly: JAX's jitted CPU program for the
    same gradients differs from its eager ops by up to 3e-3 of
    max |grad| here, more than the port differs from either."""
    batch = _batch()
    conf = _model_conf(batch)
    model = jax_init_model(dict(conf, backbone=dict(conf["backbone"],
                                                    fused_train=False)))
    pipe = JaxPipeline.from_conf(DATASET_CONF, training=True)
    cvp = JaxPipeline.from_conf(DATASET_CONF, training=False)
    trainer = JaxTrainer(model, pipe, cvp, "max_pooling", learning_rate=LR,
                         grad_clip=5.0, min_duration=5)
    mesh = make_mesh()
    state = trainer.init_state(jax.random.PRNGKey(0), batch, mesh)
    init = jax.device_get((state.params, state.batch_stats))

    def loss_and_grad(params, batch_stats):
        feats, fl = cvp(jnp.asarray(batch["waves"]),
                        jnp.asarray(batch["wave_lengths"]))

        def loss(pp):
            (probs, _), _ = model.apply(
                {"params": pp, "batch_stats": batch_stats}, feats,
                lengths=fl, train=True, mutable=["batch_stats"])
            return jax_criterion("max_pooling", probs,
                                 jnp.asarray(batch["target"]), fl, None,
                                 5)[0]
        return jax.value_and_grad(loss)(params)

    loss0, grads0 = jax.device_get(loss_and_grad(*init))
    db = shard_batch(batch, mesh)
    steps = []
    for _ in range(3):
        state, metrics = trainer.train_step(state, db,
                                            jax.random.PRNGKey(1), LR)
        steps.append((float(metrics["loss"]),
                      jax.device_get((state.params, state.batch_stats))))
    return {"batch": batch, "conf": conf, "init": init, "loss0": loss0,
            "grads0": grads0, "steps": steps}


def _port_trainer(jr, conf=None, dataset_conf=DATASET_CONF):
    conf = conf or jr["conf"]
    model = model_from_jax(*jr["init"], conf)
    return Trainer(model, DeviceFeaturePipeline.from_conf(dataset_conf),
                   DeviceFeaturePipeline.from_conf(dataset_conf,
                                                   training=False),
                   "max_pooling", grad_clip=5.0,
                   min_duration=5, device="cpu")


@pytest.mark.parametrize("fused", [True, False])
def test_step0_loss_and_grads_match_jax(jax_run, fused):
    """Step 0 on the same weights and batch (no dither, no spec_aug):
    loss 1e-5 rel, every gradient within 1e-4 of max(1, max |grad|)
    (float32 with other summation orders; features differ by ~1e-5)."""
    conf = dict(jax_run["conf"], backbone=dict(jax_run["conf"]["backbone"],
                                               fused_train=fused))
    trainer = _port_trainer(jax_run, conf)
    state = trainer.init_state()
    loss, _ = trainer.loss_and_grads(state, jax_run["batch"], seed=0)
    np.testing.assert_allclose(float(loss), float(jax_run["loss0"]),
                               rtol=1e-5)
    want = grads_from_jax(jax_run["grads0"], conf)
    named = dict(state.model.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        scale = max(float(g.abs().max()), 1.0)
        err = float((named[name].grad - g).abs().max())
        assert err <= 1e-4 * scale, f"{name}: {err} vs {scale}"


def test_three_steps_match_jax(jax_run):
    """Losses of three steps 1e-4 rel; parameters after each step within
    2 * lr * steps + 1e-5: Adam's first update is about lr * sign(g), so
    a gradient near zero (a bias ahead of a BatchNorm) can take the
    other sign in the two frameworks and move a parameter 2 * lr apart.
    BN running statistics 1e-4 after the first step (taken with equal
    parameters), then within the parameters' bound (they follow the
    drift)."""
    trainer = _port_trainer(jax_run)
    state = trainer.init_state()
    for i, (want_loss, (params, stats)) in enumerate(jax_run["steps"]):
        state, metrics = trainer.train_step(state, jax_run["batch"], 1, LR)
        assert float(metrics["skipped"]) == 0.0
        np.testing.assert_allclose(float(metrics["loss"]), want_loss,
                                   rtol=1e-4)
        want = model_from_jax(params, stats, jax_run["conf"]).state_dict()
        for name, val in state.model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                assert int(val) == i + 1
                continue
            tol = 2 * LR * (i + 1) + 1e-5
            if "running" in name:
                tol = 1e-4 if i == 0 else tol + 1e-4
            err = float((val - want[name]).abs().max())
            assert err <= tol, f"step {i}: {name} {err} > {tol}"
    assert state.step == 3


def test_optimizer_matches_optax_including_nonfinite():
    """ClipAdam against the JAX package's optax chain over four steps
    (clipped, unclipped, non-finite, weight decay on): parameters 1e-6.
    A non-finite gradient is zeroed and the step runs at lr 0, so the
    moments decay and the count advances (the JAX semantics)."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal((3, 4)).astype(np.float32),
          rng.standard_normal(5).astype(np.float32)]
    grads = [[30 * rng.standard_normal(p.shape).astype(np.float32)
              for p in p0],
             [0.1 * rng.standard_normal(p.shape).astype(np.float32)
              for p in p0],
             [np.full(p.shape, np.nan, np.float32) for p in p0],
             [rng.standard_normal(p.shape).astype(np.float32) for p in p0]]
    opt = jax_make_optimizer(LR, 5.0, 0.01)
    jp = [jnp.asarray(p) for p in p0]
    jstate = opt.init(jp)
    params = [torch.from_numpy(p.copy()).requires_grad_() for p in p0]
    port = make_optimizer(params, 5.0, 0.01)
    for g in grads:
        norm = optax.global_norm([jnp.asarray(x) for x in g])
        finite = bool(jnp.isfinite(norm))
        safe = [jnp.asarray(x if finite else np.zeros_like(x)) for x in g]
        jstate.hyperparams["learning_rate"] = jnp.asarray(
            LR if finite else 0.0)
        upd, jstate = opt.update(safe, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x)
        norm_p, skipped = port.step(LR)
        assert float(skipped) == (0.0 if finite else 1.0)
        for a, b in zip(params, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-6)
    assert int(port.count) == 4


def test_trainer_defaults_to_cuda():
    model = init_model(dict(_model_conf(_batch())))
    pipe = DeviceFeaturePipeline.from_conf(DATASET_CONF)
    if torch.cuda.is_available():
        assert Trainer(model, pipe, pipe, "max_pooling").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(model, pipe, pipe, "max_pooling")


def test_augmented_epoch_cv_checkpoints_and_average(jax_run, tmp_path):
    """The flagship recipe's dither + spec_aug path through the
    Executor: finite losses, reproducible per-step randomness, cv that
    leaves a non-finite row out, two checkpoints averaged and loaded,
    and the lr schedule."""
    batch = jax_run["batch"]
    trainer = _port_trainer(jax_run, dataset_conf=AUG_CONF)
    executor = Executor(trainer, log_interval=1,
                        metrics_path=str(tmp_path / "metrics.jsonl"))
    state = trainer.init_state()
    state, summary = executor.train(state, [batch, batch], 7, LR, 0)
    assert np.isfinite(summary["train_loss"]) and summary["batches"] == 2
    assert summary["audio_seconds_per_s"] > 0
    twin = _port_trainer(jax_run, dataset_conf=AUG_CONF)
    twin_state = twin.init_state()
    for _ in range(2):
        twin_state, _ = twin.train_step(twin_state, batch, 7, LR)
    for a, b in zip(state.model.parameters(), twin_state.model.parameters()):
        assert torch.equal(a, b)

    cv = executor.cv(state, [batch])
    assert cv["utts"] == 8 and np.isfinite(cv["cv_loss"])
    bad = dict(batch, waves=batch["waves"].copy())
    bad["waves"][0, :] = np.nan
    assert executor.cv(state, [bad])["utts"] == 7
    full = trainer.cv_step_full(state, batch)
    assert full["loss_b"].shape == (8,)
    probs, lengths = trainer.forward(state, batch["waves"],
                                     batch["wave_lengths"])
    assert probs.shape == (8, 48, 1) and int(lengths[-1]) == 38

    for epoch, cv_loss in ((0, 0.5), (1, 0.4)):
        save_checkpoint(str(tmp_path / f"{epoch}.pt"),
                        state.model.state_dict(),
                        {"epoch": epoch, "lr": LR, "cv_loss": cv_loss})
        state, _ = trainer.train_step(state, batch, 7, LR)
    assert load_checkpoint_info(str(tmp_path / "1.pt"))["cv_loss"] == 0.4
    picked = average_checkpoints(str(tmp_path), str(tmp_path / "avg.pt"), 2)
    assert [p.rsplit("/", 1)[-1] for p in picked] == ["1.pt", "0.pt"]
    first, second = (load_checkpoint(str(tmp_path / n))
                     for n in ("1.pt", "0.pt"))
    avg = load_checkpoint(str(tmp_path / "avg.pt"))
    for name, val in avg.items():
        if name.endswith(("running_mean", "running_var",
                          "num_batches_tracked")):
            assert torch.equal(val, first[name]), name
        else:
            torch.testing.assert_close(val, (first[name] + second[name]) / 2)
    assert avg["backbone.preprocessor.bn1.num_batches_tracked"].dtype == \
        torch.int64
    link_final(str(tmp_path), 1)
    served = init_model(jax_run["conf"])
    served.load_state_dict(load_checkpoint(str(tmp_path / "final.pt")))

    sched = ReduceLROnPlateau(LR, patience=1)
    lrs = [sched.step(m) for m in (1.0, 1.0, 1.0, 0.5)]
    assert lrs == [LR, LR, LR / 2, LR / 2]
