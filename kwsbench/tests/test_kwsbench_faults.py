"""Whole runs of the harness on the CPU at a tiny size, without its look
for a card: a sound program comes out correct, and each fault that a
cell can have, planted under the timed path, comes out not correct."""

import pytest
import torch

from kwsbench.tests.conftest import cpu_run


def test_sound_training_is_correct():
    out, cell = cpu_run("train_ds_tcn_b512_6s")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_audio_s_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from wekws_tpu_torch.train import steps

    def step(self, learning_rate):
        norm = torch.sqrt(sum((p.grad ** 2).sum() for p in self.params
                              if p.grad is not None))
        return norm, torch.zeros(())

    monkeypatch.setattr(steps.ClipAdam, "step", step)
    out, cell = cpu_run("train_ds_tcn_b512_6s")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(monkeypatch):
    from wekws_tpu_torch.train import steps

    real = steps.Trainer.train_step

    def half(self, state, batch, seed, lr):
        b = batch["waves"].shape[0] // 2
        return real(self, state, {k: v[:b] for k, v in batch.items()},
                    seed, lr)

    monkeypatch.setattr(steps.Trainer, "train_step", half)
    out, cell = cpu_run("train_ds_tcn_b512_6s")
    assert not out["correct"]
    assert out["checks"]["loss0_gap"]["value"] > \
        out["checks"]["loss0_gap"]["limit"]


def test_traced_run_reports_layer_metrics_only():
    out, cell = cpu_run("train_ds_tcn_b512_6s", trace=True)
    assert "train_audio_s_per_s" not in out["metrics"]
    assert out["metrics"]["train.host_ms_per_step"]["value"] > 0
    assert out["device"]["window_s"] > 0
    assert "breakdown" in out
