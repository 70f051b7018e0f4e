"""Port device frontend and feature pipeline (wekws_tpu_torch.frontend.
features, wekws_tpu_torch.data.device_pipeline) against the JAX
package on the CPU, on the same numpy inputs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wekws_tpu.data import device_pipeline as jdp
from wekws_tpu.frontend import kaldi as jax_kaldi
from wekws_tpu.frontend.features import FeatureExtractor as JaxExtractor
from wekws_tpu.frontend.features import frame_waveform as jax_frame_waveform
from wekws_tpu_torch.data import device_pipeline as pdp
from wekws_tpu_torch.frontend import kaldi
from wekws_tpu_torch.frontend.features import (
    FeatureExtractor,
    frame_waveform,
    frontend_from_dataset_conf,
)


def _waves(rng, lens):
    waves = np.zeros((len(lens), int(max(lens))), np.float32)
    for i, n in enumerate(lens):
        waves[i, :n] = rng.standard_normal(n) * 1000.0
    return waves


@pytest.mark.parametrize("feature_type,bins,ceps", [
    ("fbank", 40, 40), ("fbank", 23, 23), ("mfcc", 23, 13),
])
def test_extractor_matches_jax(rng, feature_type, bins, ceps):
    """Same folded float64 analysis matrix, float32 products on both
    sides: 1e-4 abs + 1e-5 rel on log-mel (the two libraries sum the
    400-tap DFT in different orders)."""
    kw = dict(feature_type=feature_type, num_mel_bins=bins, num_ceps=ceps,
              dither=0.0)
    lens = np.array([16000, 12345, 399, 400])
    waves = _waves(rng, lens)
    want, want_len = JaxExtractor(jax_kaldi.FrontendConfig(**kw))(
        jnp.asarray(waves), jnp.asarray(lens))
    fe = FeatureExtractor(kaldi.FrontendConfig(**kw))
    got, got_len = fe(torch.from_numpy(waves), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for i, n in enumerate(got_len.numpy()):
        np.testing.assert_allclose(got[i, :n].numpy(),
                                   np.asarray(want)[i, :n], atol=1e-4,
                                   rtol=1e-5)
    np.testing.assert_array_equal(fe._cpu["analysis"].numpy(),
                                  np.asarray(JaxExtractor(
                                      jax_kaldi.FrontendConfig(**kw))
                                      ._analysis))


def test_extractor_matches_reference_cpp_golden():
    """The bound of tests/test_frontend.py's float32 JAX extractor
    check against the reference C++ frontend."""
    from test_torch_frontend import _assert_matches_golden

    g = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "fbank_reference.npz"))
    fe = FeatureExtractor(kaldi.FrontendConfig(num_mel_bins=40, dither=0.0,
                                               wave_scale=1.0))
    for wname in ("chirp", "tones", "noise", "am", "loud"):
        wave = g[f"wave/{wname}"]
        feats, lens = fe(torch.from_numpy(wave[None, :].astype(np.float32)),
                         torch.tensor([len(wave)]))
        n = int(lens[0])
        ref = g[f"feat/{wname}/b40_16k/povey"]
        assert n == ref.shape[0]
        _assert_matches_golden(feats[0, :n].numpy(), ref, log_atol=5e-3,
                               noise_rel=1e-5)


def test_framing_and_dither_modes(rng):
    waves = torch.from_numpy(_waves(rng, [1000, 1000]))
    np.testing.assert_array_equal(
        frame_waveform(waves, 400, 160).numpy(),
        np.asarray(jax_frame_waveform(jnp.asarray(waves.numpy()), 400,
                                      160)))
    assert frame_waveform(waves[:, :300], 400, 160).shape == (2, 0, 400)
    for mode in ("wave", "frame"):
        cfg = kaldi.FrontendConfig(dither=1.0, dither_mode=mode)
        fe = FeatureExtractor(cfg)
        a, _ = fe(waves, generator=torch.Generator().manual_seed(0))
        b, _ = fe(waves, generator=torch.Generator().manual_seed(0))
        c, _ = fe(waves, generator=torch.Generator().manual_seed(1))
        plain, _ = fe(waves)
        assert torch.equal(a, b) and not torch.equal(a, c)
        # dither 1.0 on int16-scale speech moves log-mel only slightly
        assert 0 < float((a - plain).abs().mean()) < 0.05


def test_config_helper_and_fused_raise():
    conf = {"feats_type": "mfcc", "mfcc_conf": {"num_mel_bins": 23,
                                                "num_ceps": 13}}
    fe = frontend_from_dataset_conf(conf)
    assert isinstance(fe, FeatureExtractor) and fe.feat_dim == 13
    with pytest.raises(NotImplementedError, match="queue B, row 3"):
        frontend_from_dataset_conf(conf, use_fused=True)
    with pytest.raises(NotImplementedError, match="queue B, row 3"):
        pdp.DeviceFeaturePipeline.from_conf(dict(conf, fused_frontend=True))


def _jax_masks(key, b, t, d, nt, nf, max_t, max_f):
    """The keep masks wekws_tpu's spec_aug draws from ``key`` (its own
    split order), as (B, T) and (B, D) floats."""
    def mask_axis(k, size, max_len, num):
        k1, k2 = jax.random.split(k)
        starts = jax.random.randint(k1, (b, num), 0, size)
        lengths = jax.random.randint(k2, (b, num), 1, max_len)
        pos = jnp.arange(size)[None, None, :]
        masked = (pos >= starts[:, :, None]) & (
            pos < (starts + lengths)[:, :, None])
        return np.asarray(~jnp.any(masked, axis=1), np.float32)

    kt, kf = jax.random.split(key)
    return mask_axis(kt, t, max_t, nt), mask_axis(kf, d, max_f, nf)


def test_spec_aug_with_injected_jax_masks(rng):
    feats = rng.standard_normal((4, 50, 12)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    keep_t, keep_f = _jax_masks(key, 4, 50, 12, 2, 2, 20, 5)
    want = jdp.spec_aug(key, jnp.asarray(feats), 2, 2, 20, 5)
    np.testing.assert_array_equal(
        np.asarray(want), feats * keep_t[:, :, None] * keep_f[:, None, :])
    got = pdp.apply_spec_aug(torch.from_numpy(feats),
                             torch.from_numpy(keep_t),
                             torch.from_numpy(keep_f))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_spec_aug_draw_ranges():
    """Starts in [0, size), lengths in [1, max_len): one mask of
    length < max_len per axis, never empty."""
    gen = torch.Generator().manual_seed(0)
    keep_t, keep_f = pdp.spec_aug_masks((256, 30, 8), gen, 1, 1, 6, 3)
    zeros_t = (1 - keep_t).sum(dim=1)
    zeros_f = (1 - keep_f).sum(dim=1)
    assert zeros_t.min() >= 1 and zeros_t.max() <= 5
    assert zeros_f.min() >= 1 and zeros_f.max() <= 2
    assert set(zeros_t.tolist()) == {1.0, 2.0, 3.0, 4.0, 5.0}


@pytest.mark.parametrize("left,right,skip", [(2, 2, 1), (1, 0, 3),
                                             (3, 2, 2), (0, 4, 3)])
def test_splice_and_skip_match_jax(rng, left, right, skip):
    feats = rng.standard_normal((2, 11, 3)).astype(np.float32)
    x = torch.from_numpy(feats)
    want = jdp.frame_skip(jdp.context_expansion(jnp.asarray(feats), left,
                                                right), skip)
    np.testing.assert_array_equal(
        pdp.frame_skip(pdp.context_expansion(x, left, right), skip).numpy(),
        np.asarray(want))
    np.testing.assert_array_equal(
        pdp.context_expansion_skip(x, left, right, skip).numpy(),
        np.asarray(jdp.context_expansion_skip(jnp.asarray(feats), left,
                                              right, skip)))


def test_pipeline_matches_jax(rng):
    """cv pipeline (no dither, no spec_aug) with splice and skip:
    features 1e-4 abs + 1e-5 rel, lengths and dims exact; a wave_aug
    raises."""
    conf = {"feats_type": "fbank",
            "fbank_conf": {"num_mel_bins": 23, "dither": 1.0},
            "spec_aug": True, "context_expansion": True,
            "context_expansion_conf": {"left": 2, "right": 1},
            "frame_skip": 3}
    lens = np.array([8000, 5000, 401])
    waves = _waves(rng, lens)
    jp = jdp.DeviceFeaturePipeline.from_conf(conf, training=False)
    pp = pdp.DeviceFeaturePipeline.from_conf(conf, training=False)
    want, want_len = jp(jnp.asarray(waves), jnp.asarray(lens))
    got, got_len = pp(torch.from_numpy(waves), torch.from_numpy(lens))
    assert pp.output_dim == jp.output_dim == 23 * 4
    assert pp.downsample_rate == 3
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    train = pdp.DeviceFeaturePipeline.from_conf(conf, training=True)
    assert train.spec_aug_conf == {} and train.extractor.cfg.dither == 1.0
    assert pp.spec_aug_conf is None and pp.extractor.cfg.dither == 0.0
    train.wave_aug = object()
    with pytest.raises(NotImplementedError, match="item 10"):
        train(torch.from_numpy(waves), torch.from_numpy(lens))
