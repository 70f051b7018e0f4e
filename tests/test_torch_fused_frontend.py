"""Port fused frontend (ops/fused_frontend.py plain version,
FeatureExtractor(use_fused=True) on the CPU) against the JAX package's
fused Pallas frontend in interpret mode and its XLA feature path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from wekws_tpu.frontend import kaldi as jax_kaldi
from wekws_tpu.frontend.features import FeatureExtractor as JaxExtractor
from wekws_tpu_torch.data.device_pipeline import DeviceFeaturePipeline
from wekws_tpu_torch.frontend import kaldi
from wekws_tpu_torch.frontend.features import FeatureExtractor, frame_waveform
from wekws_tpu_torch.ops.fused_frontend import fused_fbank, fused_fbank_plain

CASES = [("fbank", {}), ("mfcc", {"num_ceps": 13})]


def _waves(rng, b=4, n=20800):
    return (rng.standard_normal((b, n)) * 1000).astype(np.float32)


def _fused_args(fe):
    return (fe._cpu["analysis"], fe._cpu["mel_t"], fe._cpu.get("dct"))


@pytest.mark.parametrize("ft,extra", CASES)
def test_fused_plain_matches_jax_fused_and_xla(rng, ft, extra):
    """Dither off.  JAX's two paths are bf16_3x products, the port's
    are float32: 5e-3 abs + 1e-4 rel on log-mel of magnitude ~1e1-1e2,
    the JAX suite's own bound between its two paths."""
    kw = dict(feature_type=ft, num_mel_bins=40, dither=0.0, **extra)
    waves = _waves(rng)
    jcfg = jax_kaldi.FrontendConfig(**kw)
    want_xla, _ = JaxExtractor(jcfg)(jnp.asarray(waves))
    with pltpu.force_tpu_interpret_mode():
        want_fused, want_len = JaxExtractor(jcfg, use_fused=True)(
            jnp.asarray(waves), lengths=jnp.full((4,), 20800))
    fe = FeatureExtractor(kaldi.FrontendConfig(**kw), use_fused=True)
    before = fused_fbank.launches
    got, got_len = fe(torch.from_numpy(waves), torch.full((4,), 20800))
    assert fused_fbank.launches == before  # CPU tensors: the plain version
    assert got.shape == want_fused.shape == (4, 128, fe.feat_dim)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for want in (want_fused, want_xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3,
                                   rtol=1e-4)
    cfg = fe.cfg
    plain = fused_fbank_plain(
        torch.from_numpy(waves), *_fused_args(fe),
        frame_length=cfg.frame_length, frame_shift=cfg.frame_shift)
    assert torch.equal(plain, got)
    # the port's unfused extractor is the same three float32 products
    unfused, _ = FeatureExtractor(cfg)(torch.from_numpy(waves))
    torch.testing.assert_close(got, unfused, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("ft,extra", CASES)
def test_same_noise_through_fused_plain_and_unfused(rng, ft, extra):
    """Frame-mode dither 1.0: the same (B, T, 400) noise added by the
    fused plain version and by the unfused chain agrees to 1e-4."""
    cfg = kaldi.FrontendConfig(feature_type=ft, num_mel_bins=40, dither=1.0,
                               dither_mode="frame", **extra)
    fe = FeatureExtractor(cfg, use_fused=True)
    waves = torch.from_numpy(_waves(rng, b=2, n=8000))
    frames = frame_waveform(waves, cfg.frame_length, cfg.frame_shift)
    noise = torch.from_numpy(
        rng.standard_normal(tuple(frames.shape)).astype(np.float32))
    got = fused_fbank_plain(
        waves, *_fused_args(fe), frame_length=cfg.frame_length,
        frame_shift=cfg.frame_shift, dither=1.0, noise=noise)
    mats = fe._cpu
    spec = (frames + noise) @ mats["analysis"]
    power = spec[..., :257] ** 2 + spec[..., 257:] ** 2
    want = torch.log(torch.clamp(power @ mats["mel_t"], min=kaldi.EPSILON))
    if "dct" in mats:
        want = want @ mats["dct"]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    clean = fused_fbank_plain(
        waves, *_fused_args(fe), frame_length=cfg.frame_length,
        frame_shift=cfg.frame_shift)
    assert 0 < float((got - clean).abs().mean())


def test_dither_modes_through_the_extractor(rng):
    """Wave-mode dither stays outside the fused call (the same stream as
    the unfused extractor: equal features); frame-mode dither goes into
    it, seeded from the generator: reproducible, seed-dependent, and the
    same distribution as the unfused path's."""
    waves = torch.from_numpy(_waves(rng, b=2, n=16000))
    wave_cfg = kaldi.FrontendConfig(dither=1.0, dither_mode="wave")
    a, _ = FeatureExtractor(wave_cfg, use_fused=True)(
        waves, generator=torch.Generator().manual_seed(3))
    b, _ = FeatureExtractor(wave_cfg)(
        waves, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-6)
    cfg = kaldi.FrontendConfig(dither=1.0, dither_mode="frame")
    fe = FeatureExtractor(cfg, use_fused=True)
    zeros = torch.zeros((8, 16000))
    a, _ = fe(zeros, generator=torch.Generator().manual_seed(0))
    b, _ = fe(zeros, generator=torch.Generator().manual_seed(0))
    c, _ = fe(zeros, generator=torch.Generator().manual_seed(1))
    plain, _ = fe(zeros)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(plain.max()) == pytest.approx(np.log(kaldi.EPSILON))
    unfused, _ = FeatureExtractor(cfg)(
        zeros, generator=torch.Generator().manual_seed(0))
    # log-mel of pure unit noise over 784 frames: per-bin means within
    # 0.2 and standard deviations within 25% of the unfused path's
    assert float((a.mean((0, 1)) - unfused.mean((0, 1))).abs().max()) < 0.2
    ratio = a.std((0, 1)) / unfused.std((0, 1))
    assert 0.75 < float(ratio.min()) and float(ratio.max()) < 1.25


def test_short_wave_flags_and_checks(rng):
    """A 100-sample wave yields (B, 0, D) without a launch; magnitude
    and no-log flags reach the kernel's arguments; bad inputs raise."""
    for ft, extra, dim in (("fbank", {}, 40), ("mfcc", {"num_ceps": 13}, 13)):
        fe = FeatureExtractor(kaldi.FrontendConfig(
            feature_type=ft, num_mel_bins=40, dither=0.0, **extra),
            use_fused=True)
        feats, lens = fe(torch.zeros((2, 100)), torch.tensor([100, 50]))
        assert feats.shape == (2, 0, dim) and lens.tolist() == [0, 0]
    cfg = kaldi.FrontendConfig(num_mel_bins=23, dither=0.0, use_power=False,
                               use_log_fbank=False)
    waves = torch.from_numpy(_waves(rng, b=2, n=4000))
    got, _ = FeatureExtractor(cfg, use_fused=True)(waves)
    want, _ = FeatureExtractor(cfg)(waves)
    torch.testing.assert_close(got, want, atol=0, rtol=1e-6)
    assert float(got.min()) >= 0.0
    fe = FeatureExtractor(kaldi.FrontendConfig(dither=0.0), use_fused=True)
    kw = dict(frame_length=400, frame_shift=160)
    with pytest.raises(ValueError, match="seed"):
        fused_fbank(waves, *_fused_args(fe), dither=1.0, **kw)
    with pytest.raises(TypeError, match="float32"):
        fused_fbank(waves.double(), *_fused_args(fe), **kw)
    with pytest.raises(ValueError, match="mel_t"):
        fused_fbank(waves, fe._cpu["analysis"], fe._cpu["mel_t"][:100], None,
                    **kw)


def test_pipeline_reads_fused_frontend_flag(rng):
    conf = {"feats_type": "fbank", "fbank_conf": {"num_mel_bins": 40,
                                                  "dither": 1.0,
                                                  "dither_mode": "wave"},
            "fused_frontend": True}
    waves = torch.from_numpy(_waves(rng, b=2, n=8000))
    lens = torch.tensor([8000, 5000])
    for training in (True, False):
        fused = DeviceFeaturePipeline.from_conf(conf, training=training)
        plain = DeviceFeaturePipeline.from_conf(
            dict(conf, fused_frontend=False), training=training)
        assert fused.extractor.use_fused and not plain.extractor.use_fused
        a, la = fused(waves, lens, torch.Generator().manual_seed(1))
        b, lb = plain(waves, lens, torch.Generator().manual_seed(1))
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-6)
        assert torch.equal(la, lb)
