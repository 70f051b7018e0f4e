"""Serving an exported artifact directory (export/torch_runtime
.ArtifactModelAdapter through runtime.keyword_spotter.load_serving_model)
in the port's engines on the CPU, against the JAX package's engines fed
the same directory: the committed float and static-int8 CTC fixtures
(examples/synthetic_ctc/exp/fsmn_ctc/export{,_int8}) and the DS-TCN
fixture's export."""

import os

import numpy as np
import pytest

from test_torch_export import CTC_EXPORT, CTC_INT8, REPO, ctc_waves
from wekws_tpu.runtime import BatchKeywordSpotter as JaxBatchKeywordSpotter
from wekws_tpu.runtime import KeyWordSpotter as JaxKeyWordSpotter
from wekws_tpu_torch.export.torch_runtime import ArtifactModelAdapter
from wekws_tpu_torch.runtime import (
    BatchKeywordSpotter,
    BatchMaxPoolSpotter,
    KeyWordSpotter,
)

CTC_DIR = os.path.join(REPO, "examples", "synthetic_ctc")
CTC_CONFIG = os.path.join(CTC_DIR, "exp", "fsmn_ctc", "config.yaml")
TOKENS = os.path.join(CTC_DIR, "dict", "dict.txt")
KEYWORD = "123"
CHUNK_BYTES = 9600  # 300 ms
# float: JAX's artifact-serving pin (tests/test_jax_runtime.py:203).
# int8: JAX's int8-runtime pin (tests/test_jax_runtime.py:40-49), not
# that file's 0.05, which bounds int8 against the float checkpoint: both
# engines quantize the same features to the same int8 inputs and their
# accumulators are exact, so only float32 rounding is left.  Readings on
# the CPU: port vs JAX 2.2e-8, device frontend + decode vs host 2.6e-6;
# a planted fault reads 0.12 (the float artifact served in place of the
# int8 one) and 0.36 (the zero point folded one off).
TOLS = {"float": 1e-4, "int8": 2e-5}
ARTIFACTS = {"float": CTC_EXPORT, "int8": CTC_INT8}


def pcms():
    return [np.clip(w, -32768, 32767).astype("<i2").tobytes()
            for w in ctc_waves(4)]


def tap(detector, seen):
    """Record every chunk of posteriors a detector is given."""
    orig = detector.process

    def spy(idx, p):
        seen.append(np.asarray(p).copy())
        return orig(idx, p)

    detector.process = spy


def spotter_run(spot):
    """Each utterance in 300 ms chunks (state reset between them): the
    posteriors seen and the detections."""
    seen, events = [], []
    tap(spot.detector, seen)
    for pcm in pcms():
        spot.reset_all()
        for off in range(0, len(pcm), CHUNK_BYTES):
            r = spot.forward(pcm[off:off + CHUNK_BYTES])
            if r and r.get("state") == 1:
                events.append((r["keyword"], r["start"], r["end"],
                               r["score"]))
    return np.concatenate(seen), events


def batch_run(eng):
    """The utterances on three streams at once, every step drained, then
    a flush: per stream the posteriors its detector saw (host decode),
    and the sorted detections."""
    waves = pcms()[:3]
    seen = {i: [] for i in range(3)}
    if not eng.device_decode:
        for i, det in enumerate(eng.detectors):
            tap(det, seen[i])
    events = []

    def take(results):
        events.extend((i, r["keyword"], round(r["start"], 2),
                       round(r["end"], 2), r["score"])
                      for i, r in results.items() if r and r.get("state"))

    for off in range(0, max(len(p) for p in waves), CHUNK_BYTES):
        for i, p in enumerate(waves):
            if off < len(p):
                eng.accept_wave(i, p[off:off + CHUNK_BYTES])
        while True:
            res = eng.step()
            if not res:
                break
            take(res)
    take(eng.flush())
    return {i: np.concatenate(s) for i, s in seen.items() if s}, \
        sorted(events)


def port_batch(art, **kw):
    eng = BatchKeywordSpotter(art, CTC_CONFIG, TOKENS, None, 0.1,
                              num_streams=3, step_frames=8, min_frames=1,
                              use_fused=None, device="cpu", **kw)
    eng.set_keywords(KEYWORD)
    return eng


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's ``KeyWordSpotter`` and host-decode ``BatchKeywordSpotter``
    fed each fixture directory (one engine each)."""
    out = {}
    for kind, art in ARTIFACTS.items():
        spot = JaxKeyWordSpotter(art, CTC_CONFIG, TOKENS, None, 0.1)
        spot.set_keywords(KEYWORD)
        eng = JaxBatchKeywordSpotter(art, CTC_CONFIG, TOKENS, None, 0.1,
                                     num_streams=3, step_frames=8,
                                     min_frames=1)
        eng.set_keywords(KEYWORD)
        out[kind] = (spotter_run(spot), batch_run(eng))
    return out


@pytest.mark.parametrize("kind", sorted(ARTIFACTS))
def test_spotter_matches_jax(jax_runs, kind):
    """``KeyWordSpotter`` on an artifact directory (``use_fused=None``
    takes the artifact's own ops): every posterior within ``TOLS`` of
    JAX's engine on the same directory, and the same detections
    (keyword, start, end; score within it)."""
    spot = KeyWordSpotter(ARTIFACTS[kind], CTC_CONFIG, TOKENS, None, 0.1,
                          use_fused=None, device="cpu")
    assert isinstance(spot.model, ArtifactModelAdapter)
    spot.set_keywords(KEYWORD)
    got, got_events = spotter_run(spot)
    want, want_events = jax_runs[kind][0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOLS[kind], rtol=0)
    assert want_events, "no detections: the comparison is vacuous"
    assert [e[:3] for e in got_events] == [e[:3] for e in want_events]
    np.testing.assert_allclose([e[3] for e in got_events],
                               [e[3] for e in want_events], atol=TOLS[kind])


@pytest.mark.parametrize("kind", sorted(ARTIFACTS))
def test_batch_spotter_matches_jax(jax_runs, kind):
    """``BatchKeywordSpotter`` (host decode, host frontend) on an
    artifact directory against JAX's on the same directory: each
    stream's posteriors within tolerance, the same detections."""
    got, got_events = batch_run(port_batch(ARTIFACTS[kind]))
    want, want_events = jax_runs[kind][1]
    assert got.keys() == want.keys() == {0, 1, 2}
    for i in want:
        np.testing.assert_allclose(got[i], want[i], atol=TOLS[kind], rtol=0)
    assert want_events
    assert [e[:4] for e in got_events] == [e[:4] for e in want_events]


@pytest.mark.parametrize("kind", sorted(ARTIFACTS))
def test_batch_spotter_device_modes(kind):
    """The artifact served with the device frontend and device decode
    (on the CPU: the featurizer's plain chain, the batched beam search)
    gives the host-frontend, host-decode engine's detections, scores
    within ``TOLS``."""
    _, want = batch_run(port_batch(ARTIFACTS[kind]))
    _, got = batch_run(port_batch(ARTIFACTS[kind], device_frontend=True,
                                  device_decode=True))
    assert want
    assert [e[:4] for e in got] == [e[:4] for e in want]
    np.testing.assert_allclose([e[4] for e in got], [e[4] for e in want],
                               atol=TOLS[kind])


@pytest.mark.parametrize("engine", ["spotter", "batch", "maxpool"])
def test_use_fused_true_raises_for_an_artifact(engine):
    """There is no fused kernel behind a graph artifact: ``use_fused=
    True`` raises, never a quiet change of route."""
    build = {
        "spotter": lambda: KeyWordSpotter(CTC_EXPORT, CTC_CONFIG, TOKENS,
                                          None, 0.1, use_fused=True,
                                          device="cpu"),
        "batch": lambda: BatchKeywordSpotter(CTC_EXPORT, CTC_CONFIG, TOKENS,
                                             None, 0.1, use_fused=True,
                                             device="cpu"),
        "maxpool": lambda: BatchMaxPoolSpotter(CTC_EXPORT, CTC_CONFIG, 0.5,
                                               use_fused=True, device="cpu"),
    }
    with pytest.raises(ValueError, match="graph artifact has no fused"):
        build[engine]()


def test_maxpool_serves_ds_tcn_export():
    """``BatchMaxPoolSpotter`` on the DS-TCN fixture's committed export
    against the same engine on its avg_5.ckpt (module route): the same
    posteriors within 1e-4 (the artifact folds BN), the same
    detections."""
    import yaml

    fx = os.path.join(REPO, "examples", "synthetic", "exp", "ds_tcn")
    with open(os.path.join(fx, "config.yaml")) as f:
        configs = yaml.safe_load(f)
    configs["model"]["cmvn"]["cmvn_file"] = os.path.join(
        REPO, "examples", "synthetic", "data", "global_cmvn")
    rng = np.random.default_rng(2)
    waves = [(rng.standard_normal(20000) * 2000).astype("<i2").tobytes()
             for _ in range(2)]

    def run(ckpt):
        eng = BatchMaxPoolSpotter(ckpt, configs, 0.02, num_streams=2,
                                  step_frames=8, use_fused=None,
                                  device="cpu")
        probs, step = [], eng._step_fn

        def spy(*args):
            out = step(*args)
            probs.append(out[0].clone())
            return out

        eng._step_fn = spy
        events = []
        for off in range(0, len(waves[0]), CHUNK_BYTES):
            for i, p in enumerate(waves):
                eng.accept_wave(i, p[off:off + CHUNK_BYTES])
            while True:
                res = eng.step()
                if not res:
                    break
                events += sorted((i, r["keyword"], r["frame"])
                                 for i, r in res.items()
                                 if r.get("state") == 1)
        return probs, events

    got, got_events = run(os.path.join(fx, "export"))
    want, want_events = run(os.path.join(fx, "avg_5.ckpt"))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4,
                                   rtol=1e-4)
    assert got_events == want_events
