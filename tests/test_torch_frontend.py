"""Port frontend (wekws_tpu_torch.frontend / runtime.streaming_frontend)
against the JAX package's numpy oracle and the reference-C++ golden."""

import os

import numpy as np
import pytest

from wekws_tpu.frontend import kaldi as jax_kaldi
from wekws_tpu.frontend.cmvn import load_cmvn as jax_load_cmvn
from wekws_tpu.frontend.features import (
    frontend_from_dataset_conf as jax_frontend_from_dataset_conf,
)
from wekws_tpu.runtime.streaming_frontend import (
    StreamingFrontend as JaxStreamingFrontend,
)
from wekws_tpu_torch.frontend import kaldi
from wekws_tpu_torch.frontend.cmvn import load_cmvn
from wekws_tpu_torch.frontend.features import frontend_from_dataset_conf
from wekws_tpu_torch.runtime.streaming_frontend import StreamingFrontend


def _cfg_pair(**kw):
    return jax_kaldi.FrontendConfig(**kw), kaldi.FrontendConfig(**kw)


@pytest.mark.parametrize("feature_type,bins,ceps", [
    ("fbank", 40, 40), ("fbank", 23, 23), ("mfcc", 23, 13),
])
def test_features_equal_jax_oracle(rng, feature_type, bins, ceps):
    """Same numpy code: bit-identical features."""
    jcfg, pcfg = _cfg_pair(feature_type=feature_type, num_mel_bins=bins,
                           num_ceps=ceps)
    wave = rng.standard_normal(8000) * 3000.0
    if feature_type == "fbank":
        want = jax_kaldi.compute_fbank_np(wave, jcfg)
        got = kaldi.compute_fbank_np(wave, pcfg)
    else:
        want = jax_kaldi.compute_mfcc_np(wave, jcfg)
        got = kaldi.compute_mfcc_np(wave, pcfg)
    np.testing.assert_array_equal(got, want)
    assert kaldi.num_frames(len(wave), pcfg) == got.shape[0]
    np.testing.assert_array_equal(kaldi.povey_window(400),
                                  jax_kaldi.povey_window(400))
    np.testing.assert_array_equal(kaldi.mel_banks(bins, 512, 16000.0),
                                  jax_kaldi.mel_banks(bins, 512, 16000.0))


def _assert_matches_golden(got, ref, log_atol=2e-3, noise_rel=3e-6):
    """The envelope of tests/test_frontend.py: energies with a noise
    floor proportional to each frame's peak, logs above the floor."""
    assert got.shape == ref.shape
    if ref.size == 0:
        return
    e_got = np.exp(got.astype(np.float64))
    e_ref = np.exp(ref.astype(np.float64))
    frame_peak = e_ref.max(axis=1, keepdims=True)
    bad = np.abs(e_got - e_ref) > 5e-3 * e_ref + noise_rel * frame_peak
    assert not bad.any(), f"energy mismatch at {np.argwhere(bad)[:5]}"
    above = e_ref >= 1e-4 * frame_peak
    d = np.abs(got - ref)[above]
    assert d.size == 0 or d.max() <= log_atol, d.max()


def test_fbank_matches_reference_cpp_golden():
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "fbank_reference.npz")
    g = np.load(path)
    checked = 0
    for key in g.files:
        if not key.startswith("feat/"):
            continue
        _, wname, tag, win = key.split("/")
        cfg = kaldi.FrontendConfig(
            num_mel_bins=int(tag.split("_")[0][1:]),
            sample_rate=8000 if tag.endswith("8k") else 16000,
            window_type=win, dither=0.0, wave_scale=1.0,
        )
        got = kaldi.compute_fbank_np(g[f"wave/{wname}"].astype(np.float64),
                                     cfg)
        _assert_matches_golden(got, g[key])
        checked += 1
    assert checked == 34


@pytest.mark.parametrize("left,right,skip", [(0, 0, 1), (2, 2, 3)])
def test_streaming_frontend_equals_jax(rng, left, right, skip):
    """Chunked bookkeeping (wave_remained, splice, frame skip) is
    identical to the JAX package's, chunk by chunk."""
    jcfg, pcfg = _cfg_pair(num_mel_bins=23)
    jax_fe = JaxStreamingFrontend(jcfg, left, right, skip)
    port_fe = StreamingFrontend(pcfg, left, right, skip)
    wave = (rng.standard_normal(16000) * 1000).astype(np.float32)
    sizes = [100, 399, 1, 1600, 4800, 37, 3200]
    off, n_out = 0, 0
    while off < len(wave):
        size = sizes[off % len(sizes)]
        chunk = wave[off:off + size]
        off += size
        jf, ji = jax_fe.accept_waveform(chunk)
        pf, pi = port_fe.accept_waveform(chunk)
        np.testing.assert_array_equal(pf, jf)
        np.testing.assert_array_equal(pi, ji)
        n_out += pf.shape[0]
    assert n_out > 10


def test_config_and_cmvn_loaders_equal_jax(tmp_path):
    conf = {"feats_type": "fbank",
            "fbank_conf": {"num_mel_bins": 40, "frame_shift": 10,
                           "frame_length": 25, "dither": 1.0,
                           "dither_mode": "wave"}}
    assert frontend_from_dataset_conf(conf).cfg == (
        kaldi.FrontendConfig(**vars(jax_frontend_from_dataset_conf(conf)
                                    .cfg)))
    path = tmp_path / "global_cmvn.json"
    path.write_text('{"mean_stat": [10.0, 20.0, 30.0], '
                    '"var_stat": [60.0, 220.0, 500.0], "frame_num": 10}')
    for got, want in zip(load_cmvn(str(path)), jax_load_cmvn(str(path))):
        np.testing.assert_array_equal(got, want)
