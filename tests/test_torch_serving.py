"""Port serving engine and scoring against the JAX package.

A JAX ``BatchMaxPoolSpotter`` built from a JAX checkpoint and the
port's, built from the bridged ``.pt``, are fed the same staggered
chunks; posteriors and events must agree."""

import jax
import numpy as np
import pytest
import torch
import yaml

from wekws_tpu.eval import compute_det as jax_compute_det
from wekws_tpu.eval import load_label_and_score as jax_load_label_and_score
from wekws_tpu.eval import write_score_file as jax_write_score_file
from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.runtime import BatchMaxPoolSpotter as JaxBatchMaxPoolSpotter
from wekws_tpu.train import save_checkpoint
from wekws_tpu_torch.eval import (
    compute_det,
    frr_at_fa_per_hour,
    load_label_and_score,
    write_score_file,
)
from wekws_tpu_torch.frontend import compute_fbank_np
from wekws_tpu_torch.runtime import BatchMaxPoolSpotter
from wekws_tpu_torch.runtime.keyword_spotter import load_spotter_config
from wekws_tpu_torch.tools.from_jax import model_from_jax

N_STREAMS = 3
CHUNKS = [4800, 9600, 3200]  # int16 samples per accept_wave, per stream


def _run(engine, waves, capture_attr):
    """Staggered feeding as tests/test_runtime.py does; returns per
    stream posteriors and the ordered list of fired events."""
    probs = [[] for _ in range(N_STREAMS)]
    orig = getattr(engine, capture_attr)

    def capture(feats, active, reset, cache):
        out, c = orig(feats, active, reset, cache)
        p = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        for i in range(N_STREAMS):
            if active[i]:
                probs[i].append(p[i])
        return out, c

    setattr(engine, capture_attr, capture)
    events = []
    offsets = [0] * N_STREAMS
    while any(offsets[i] < len(waves[i]) for i in range(N_STREAMS)):
        for i in range(N_STREAMS):
            if offsets[i] < len(waves[i]):
                engine.accept_wave(i, waves[i][offsets[i]:offsets[i]
                                               + 2 * CHUNKS[i]])
                offsets[i] += 2 * CHUNKS[i]
        events += [(i, r) for i, r in sorted(engine.step().items())
                   if r["state"]]
    events += [(i, r) for i, r in sorted(engine.flush().items())
               if r["state"]]
    return [np.concatenate(p, axis=0) for p in probs], events


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """JAX checkpoint + bridged port checkpoint, a threshold that sits in
    a wide gap of the posteriors, and the JAX engine's run."""
    tmp = tmp_path_factory.mktemp("serving")
    rng = np.random.default_rng(7)
    configs = {
        "dataset_conf": {
            "feats_type": "fbank",
            "fbank_conf": {"num_mel_bins": 23, "frame_shift": 10,
                           "frame_length": 25, "dither": 1.0},
        },
        "model": {
            "input_dim": 23, "output_dim": 2, "hidden_dim": 32,
            "preprocessing": {"type": "linear"},
            "backbone": {"type": "mdtc", "num_stack": 2, "stack_size": 3,
                         "kernel_size": 5, "hidden_dim": 32,
                         "causal": True},
        },
    }
    waves = [(rng.standard_normal(12000) * 1000).astype("<i2")
             for _ in range(N_STREAMS)]
    _, cfg, _, _, _ = load_spotter_config(configs)
    feats = np.concatenate([compute_fbank_np(w.astype(np.float32), cfg)
                            for w in waves])
    configs["model"]["cmvn"] = {
        "mean": feats.mean(0).tolist(),
        "istd": (1.0 / (feats.std(0) + 1e-6)).tolist(), "norm_var": True,
    }
    config_path = tmp / "config.yaml"
    config_path.write_text(yaml.dump(configs))
    model = jax_init_model(configs["model"])
    variables = model.init(jax.random.PRNGKey(0), feats[None, :10])
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * np.arange(a.size, dtype=np.float32)
        .reshape(a.shape) / max(a.size, 1),
        variables["batch_stats"],
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    jax_ckpt = tmp / "final.ckpt"
    save_checkpoint(str(jax_ckpt), params, stats)
    port_model = model_from_jax(params, stats, configs["model"])
    port_ckpt = tmp / "final.pt"
    torch.save(port_model.state_dict(), port_ckpt)

    with torch.inference_mode():
        offline, _ = port_model(torch.from_numpy(feats[None]))
    vals = np.unique(offline.numpy().ravel())
    band = vals[(vals > np.quantile(vals, 0.8)) & (vals < np.quantile(vals,
                                                                      0.98))]
    gap = int(np.argmax(np.diff(band)))
    assert band[gap + 1] - band[gap] > 1e-3
    threshold = float(band[gap] + band[gap + 1]) / 2

    pcm = [w.tobytes() for w in waves]
    jax_engine = JaxBatchMaxPoolSpotter(
        str(jax_ckpt), str(config_path), threshold,
        num_streams=N_STREAMS, step_frames=8, interval_frames=20,
    )
    jax_probs, jax_events = _run(jax_engine, pcm, "_step_jit")
    return {"ckpt": str(port_ckpt), "config": str(config_path),
            "threshold": threshold, "pcm": pcm,
            "jax_probs": jax_probs, "jax_events": jax_events}


@pytest.mark.parametrize("use_fused,atol", [(False, 1e-5), (True, 2e-4)])
def test_batch_maxpool_spotter_matches_jax(served, use_fused, atol):
    engine = BatchMaxPoolSpotter(
        served["ckpt"], served["config"], served["threshold"],
        num_streams=N_STREAMS, step_frames=8, interval_frames=20,
        use_fused=use_fused, device="cpu",
    )
    probs, events = _run(engine, served["pcm"], "_step_fn")
    for got, want in zip(probs, served["jax_probs"]):
        assert got.shape == want.shape and got.shape[0] > 60
        np.testing.assert_allclose(got, want, atol=atol, rtol=atol)
    assert len(events) == len(served["jax_events"]) > 0
    for (i, got), (j, want) in zip(events, served["jax_events"]):
        assert i == j
        assert got["keyword"] == want["keyword"]
        assert got["frame"] == want["frame"]
        assert got["score"] == pytest.approx(want["score"], abs=atol)


def test_port_engine_restores_inactive_rows(served):
    """A stream that sits out steps and a recycled slot behave like a
    fresh single-stream engine (lockstep masking, reset mask)."""
    kw = dict(num_streams=N_STREAMS, step_frames=8, use_fused=True,
              device="cpu")
    single = BatchMaxPoolSpotter(served["ckpt"], served["config"], 2.0,
                                 **dict(kw, num_streams=1))
    probs = []
    orig = single._step_fn

    def capture(feats, active, reset, cache):
        out, c = orig(feats, active, reset, cache)
        probs.append(out.numpy()[0])
        return out, c

    single._step_fn = capture
    single.accept_wave(0, served["pcm"][2])
    single.flush()
    want = np.concatenate(probs)

    engine = BatchMaxPoolSpotter(served["ckpt"], served["config"], 2.0, **kw)
    got = []
    orig_b = engine._step_fn

    def capture_b(feats, active, reset, cache):
        out, c = orig_b(feats, active, reset, cache)
        if active[2]:
            got.append(out.numpy()[2])
        return out, c

    engine._step_fn = capture_b
    engine.accept_wave(0, served["pcm"][0])
    engine.accept_wave(2, served["pcm"][1][:6400])
    engine.step()
    engine.reset_stream(2)  # slot recycled mid-run
    got.clear()
    engine.accept_wave(2, served["pcm"][2])
    engine.flush()
    np.testing.assert_allclose(np.concatenate(got), want, atol=1e-6)


def test_score_file_and_det_equal_jax(tmp_path, rng):
    keys = [f"u{i}" for i in range(6)]
    probs = rng.random((6, 30, 2)).astype(np.float32)
    lengths = np.asarray([30, 20, 25, 30, 11, 28])
    batch = {"keys": keys, "valid": np.asarray([1, 1, 1, 1, 1, 1])}
    forward = lambda b: (probs, lengths)  # noqa: E731
    paths = {}
    for name, fn in (("jax", jax_write_score_file),
                     ("port", write_score_file)):
        paths[name] = tmp_path / f"score_{name}.txt"
        assert fn(forward, [batch], ["HI", "OK"], str(paths[name])) == 6
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    labels = tmp_path / "labels.jsonl"
    labels.write_text("".join(
        f'{{"key": "{k}", "txt": "{"HI" if i < 3 else "noise"}", '
        f'"duration": 1.5}}\n' for i, k in enumerate(keys)))
    got = load_label_and_score("HI", str(labels), str(paths["port"]))
    want = jax_load_label_and_score("HI", str(labels), str(paths["jax"]))
    assert got == want
    det = compute_det(*got, window_shift=5)
    assert det == jax_compute_det(*want, window_shift=5)
    assert 0.0 <= frr_at_fa_per_hour(det, 1000.0) <= 1.0
