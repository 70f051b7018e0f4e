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


# ---- the kernel's FFT plan: its operands, schedule and checks

from wekws_tpu_torch.frontend.features import analysis_matrix  # noqa: E402
from wekws_tpu_torch.ops import fused_frontend as ff  # noqa: E402


@pytest.mark.parametrize("window", ["povey", "hamming"])
@pytest.mark.parametrize("preemphasis", [0.0, 0.97])
@pytest.mark.parametrize("remove_dc", [True, False])
@pytest.mark.parametrize("pow2", [True, False])
def test_fft_operands_equal_the_folded_analysis(rng, window, preemphasis,
                                                remove_dc, pow2):
    """In float64: DC removal, Kaldi preemphasis, the window and a real
    FFT of the zero-padded frame (the FFT plan's route, from the
    extractor's operands) equal frames @ analysis (the dense plan's
    folded operator, the plain version's) within 1e-9 of the largest
    bin; n_fft 512, or the frame's own 400 (round_to_power_of_two
    false, the dense plan's size)."""
    cfg = kaldi.FrontendConfig(window_type=window, preemphasis=preemphasis,
                               remove_dc_offset=remove_dc,
                               round_to_power_of_two=pow2)
    fe = FeatureExtractor(cfg, use_fused=True)
    ops = fe.fft_operands(fe._cpu)
    assert ops["n_fft"] == cfg.padded_window_size == (512 if pow2 else 400)
    assert ff.fbank_plan(ops["n_fft"]) == ("fft" if pow2 else "dense")
    frames = rng.standard_normal((6, cfg.frame_length)) * 1000.0
    x = frames - (frames.mean(axis=1, keepdims=True)
                  if ops["remove_dc_offset"] else 0.0)
    prev = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    # the window in float64; the kernel's operand is it rounded once
    x = (x - ops["preemphasis"] * prev) * cfg.window()
    spec = np.fft.rfft(x, n=ops["n_fft"], axis=1)
    folded = frames @ analysis_matrix(cfg)
    nbin = ops["n_fft"] // 2 + 1
    want = np.concatenate([spec.real, spec.imag], axis=1)
    assert folded.shape == want.shape == (6, 2 * nbin)
    np.testing.assert_allclose(folded, want, rtol=0,
                               atol=1e-9 * np.abs(want).max())
    np.testing.assert_allclose(
        ops["window"].numpy(), cfg.window().astype(np.float32))
    # the low bins' columns of the folded operator, as [re, im] pairs
    low, a32 = ops["low"].numpy(), fe._cpu["analysis"].numpy()
    fl = cfg.frame_length
    assert low.shape == (-(-fl // 32) * 32, 2 * ff.LOW_BINS)
    np.testing.assert_array_equal(low[:fl, 0::2], a32[:, :ff.LOW_BINS])
    np.testing.assert_array_equal(low[:fl, 1::2],
                                  a32[:, nbin:nbin + ff.LOW_BINS])
    assert not low[fl:].any()


@pytest.mark.parametrize("n_fft", ff.FFT_SIZES)
def test_twiddle_table_and_the_kernels_fft_schedule(rng, n_fft):
    """The table is exp(-2 pi i m / n_fft) rounded once to float32; the
    kernel's schedule (packed pairs, Stockham stages of the radices of
    ``fft_radices``, the split pass) reproduces numpy's rfft in float64
    within 1e-12 of the largest bin."""
    tw = ff.twiddle_table(n_fft)
    assert tw.dtype == torch.float32 and tuple(tw.shape) == (n_fft, 2)
    ref = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    np.testing.assert_allclose(tw[:, 0].numpy(), ref.real, atol=6e-8)
    np.testing.assert_allclose(tw[:, 1].numpy(), ref.imag, atol=6e-8)
    n = n_fft // 2
    radices = ff.fft_radices(n_fft)
    assert int(np.prod(radices)) == n and all(r in (2, 4, 8, 16)
                                              for r in radices)
    x = rng.standard_normal(n_fft)
    z = x[0::2] + 1j * x[1::2]
    ns = 1
    for rs in radices:  # csrc/fused_frontend.cu fft_stage
        out = np.empty_like(z)
        for j in range(n // rs):
            k = j % ns
            v = z[j + np.arange(rs) * (n // rs)] * ref[
                2 * k * np.arange(rs) * (n // (ns * rs))]
            v = np.fft.fft(v)
            out[(j // ns) * ns * rs + k + np.arange(rs) * ns] = v
        z, ns = out, ns * rs
    k = np.arange(n // 2 + 1)
    a, b = z[k], z[(n - k) % n]
    e = 0.5 * (a + np.conj(b))
    o = -0.5j * (a - np.conj(b))
    spec = np.zeros(n + 1, complex)
    spec[k] = e + ref[k] * o
    spec[n - k] = np.conj(e - ref[k] * o)
    want = np.fft.rfft(x)
    np.testing.assert_allclose(spec, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_plan_choice_and_block_sizes():
    """Powers of two from 128 to 2048 take the FFT plan, any other
    padded size (or none) the dense plan.  A block's frames fill 16,384
    floats; a block fits an SM at every size, two at 25 ms frames of
    16 kHz (and of 8 kHz up to 40 bins)."""
    for n in ff.FFT_SIZES:
        assert ff.fbank_plan(n) == "fft"
        assert ff.fft_frames(n) * n == ff.FFT_FLOATS
        for m in (23, 40, 80):
            smem = ff.fft_smem_bytes(n, min(n, 400), 2 * (n // 2 + 1) + m, m)
            assert smem <= 232448
            # 25 ms at 16 kHz (and at 8 kHz up to 40 bins): two blocks an SM
            if n == 512 or (n == 256 and m <= 40):
                assert 2 * (smem + 1024) <= 233472
    for n in (None, 64, 400, 401, 4096):
        assert ff.fbank_plan(n) == "dense"
        if n is not None:
            with pytest.raises(ValueError, match="no FFT plan"):
                ff.fft_frames(n)
    # 32 frames of 512 points: twiddles 4 KB, frames 69.9 KB, window,
    # 492 packed weights, 40 bands, the 32 x 40 log-mel tile, 16 low bins
    # and two chunks of 32 rows of their operator
    assert ff.fft_smem_bytes(512, 400, 492, 40) == 4 * (
        1024 + 32 * 546 + 400 + 492 + 120 + 1280 + 32 * 16 + 2 * 32 * 32)


@pytest.mark.parametrize("n_mel", [23, 40, 80])
def test_mel_bands_hold_every_nonzero_once(n_mel):
    fe = FeatureExtractor(kaldi.FrontendConfig(num_mel_bins=n_mel))
    mel_t = fe._cpu["mel_t"]
    for dense in (False, True):
        bands, n_band = ff.mel_bands(mel_t, dense=dense)
        assert bands.dtype == torch.int32 and tuple(bands.shape) == (n_mel, 3)
        lo, hi, off = bands.numpy().T
        assert off[0] == 0 and np.all(off[1:] == off[:-1] + (hi - lo)[:-1])
        assert n_band == off[-1] + hi[-1] - lo[-1]
        for m in range(n_mel):
            nz = np.flatnonzero(mel_t[:, m].numpy())
            assert lo[m] <= nz.min() and nz.max() < hi[m]
            if dense:
                assert (lo[m], hi[m]) == (0, mel_t.shape[0])
            else:
                assert (lo[m], hi[m]) == (nz.min(), nz.max() + 1)
    assert fe.n_band == ff.mel_bands(mel_t)[1] < 2 * mel_t.shape[0]


@pytest.mark.parametrize("bad", ["window", "twiddles", "low", "bands_dtype",
                                 "n_band", "n_fft", "missing"])
def test_wrapper_checks_the_fft_operands(rng, bad):
    fe = FeatureExtractor(kaldi.FrontendConfig(dither=0.0), use_fused=True)
    waves = torch.from_numpy(_waves(rng, b=2, n=4000))
    ops = fe.fft_operands(fe._cpu)
    kw = dict(frame_length=400, frame_shift=160)
    err = ValueError
    if bad == "window":
        ops["window"] = ops["window"][:399]
    elif bad == "twiddles":
        ops["twiddles"] = ops["twiddles"][:256]
    elif bad == "low":
        ops["low"] = ops["low"][:, :16].contiguous()
    elif bad == "bands_dtype":
        ops["bands"], err = ops["bands"].long(), TypeError
    elif bad == "n_band":
        ops["n_band"] += 1
    elif bad == "n_fft":
        ops["n_fft"] = 1024
    else:
        del ops["bands"]
    with pytest.raises(err):
        fused_fbank(waves, *_fused_args(fe), **ops, **kw)
    good = fe.fft_operands(fe._cpu)
    got = fused_fbank(waves, *_fused_args(fe), **good, **kw)
    torch.testing.assert_close(got, fe(waves)[0], atol=0, rtol=0)
