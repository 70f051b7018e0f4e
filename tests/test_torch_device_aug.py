"""The port's device waveform augmentation (wekws_tpu_torch.data.
device_aug) against the JAX package's data/device_aug.py on the CPU.

Each test gives both packages the same numpy inputs, made from a seed,
and the port JAX's random draws: ``jax_draws`` replays the JAX
package's key splits (``fold_in``, ``split``, ``randint``, ``uniform``)
and hands the results to the port as its draw tensors.  JAX runs at
``precision="highest"`` and float32.  Bounds: the JAX suite's
(tests/test_device_aug.py) against the host chain; against JAX, 1e-2
abs on the int16 scale where the two sum float32 products in another
order."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wekws_tpu.data import device_aug as jaug
from wekws_tpu.data.device_pipeline import (
    DeviceFeaturePipeline as JaxPipeline,
)
from wekws_tpu_torch.data import DeviceFeaturePipeline, audio
from wekws_tpu_torch.data import device_aug as paug
from wekws_tpu_torch.data.resident import gather_rows, stage_arrays
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.tools.make_blob import make_blob
from wekws_tpu_torch.train import Trainer

KEY = jax.random.PRNGKey(0)
SCALE = 1.0 / 32768.0
FBANK_CONF = {"feats_type": "fbank",
              "fbank_conf": {"num_mel_bins": 23, "frame_shift": 10,
                             "frame_length": 25, "dither": 0.0}}


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def jax_draws(rng, b, aug):
    """The draws of the JAX package's ``DeviceWaveAug.__call__(rng,
    ...)`` for ``b`` rows, as the port's draw tensors."""
    out = {}
    if aug.speed_perturb and not (aug.speed_partition
                                  and b >= len(aug.speeds)):
        out["choice"] = jax.random.randint(
            jax.random.fold_in(rng, 1), (b,), 0, len(aug.speeds))
    if aug.rir_re is not None and aug.reverb_prob > 0:
        k1, k2 = jax.random.split(jax.random.fold_in(rng, 2))
        out["rir_pick"] = jax.random.randint(k1, (b,), 0, aug.n_rirs)
        out["rir_apply_u"] = jax.random.uniform(k2, (b,))
    if aug.noise_rows is not None and aug.noise_prob > 0:
        k1, k3, k4 = jax.random.split(jax.random.fold_in(rng, 3), 3)
        out["noise_pick"] = jax.random.randint(k1, (b,), 0,
                                               aug.n_noise_rows)
        out["snr_u"] = jax.random.uniform(k3, (b,))
        out["noise_apply_u"] = jax.random.uniform(k4, (b,))
    return {k: _t(v, torch.int64 if "pick" in k or k == "choice" else None)
            for k, v in out.items()}


def host_noise_mix(wave, noise, snr, scale=SCALE):
    """The reference's add_noise math on [-1, 1) copies of int16-scale
    arrays (tests/test_device_aug.py's)."""
    w, n = wave * scale, noise * scale
    audio_db = 10 * np.log10(np.mean(w ** 2) + 1e-4)
    noise_db = 10 * np.log10(np.mean(n ** 2) + 1e-4)
    return wave + np.sqrt(10 ** ((audio_db - noise_db - snr) / 10)) * noise


def unit_rirs(rng, n, r):
    rirs = rng.standard_normal((n, r)).astype(np.float32)
    return rirs / np.sqrt((rirs.astype(np.float64) ** 2).sum(
        1, keepdims=True)).astype(np.float32)


def spectra(fft, rirs):
    spec = np.stack([fft.spectrum_mat_half(r).reshape(-1) for r in rirs])
    return spec.real.copy(), spec.imag.copy()


# -- speed perturbation ------------------------------------------------------


@pytest.mark.parametrize("speed", [0.9, 1.1])
def test_speed_lengths_exact(speed):
    """JAX's 4,000-length sweep: new lengths floor(len * q / p) on
    integers equal JAX's and the host's ``audio.speed_perturb`` for
    every length (int64 lengths in the port, int32 in JAX)."""
    lens = np.arange(1, 4000, 7, dtype=np.int32)
    waves = np.zeros((len(lens), 4000), np.float32)
    _, want = jaug.speed_perturb_batch(KEY, jnp.asarray(waves),
                                       jnp.asarray(lens), speeds=(speed,))
    _, got = paug.speed_perturb_batch(
        torch.from_numpy(waves), _t(lens, torch.int64),
        torch.zeros(len(lens), dtype=torch.int64), speeds=(speed,))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    host = [len(audio.speed_perturb(np.zeros(int(n), np.float32), speed))
            for n in lens]
    np.testing.assert_array_equal(got.numpy(), host)


def _speed_rows(rng, b=7, s=3000):
    waves = (rng.standard_normal((b, s)) * 800).astype(np.float32)
    lengths = np.asarray([s, s - 100, s, s - 3, s, s, s - 50][:b], np.int32)
    for i in range(b):
        waves[i, lengths[i]:] = 0.0
    return waves, lengths


@pytest.mark.parametrize("form", ["group", "per_row"])
def test_speed_perturb_matches_jax_and_host(rng, form):
    """Both forms: 1e-2 abs against JAX (its strided conv, the port's
    matmul: two nonzero taps an output, other summation order), lengths
    exact, 2.0 abs against the host ``audio.speed_perturb`` (float64
    positions), zero past each new length."""
    waves, lengths = _speed_rows(rng)
    speeds = (0.9, 1.0, 1.1)
    if form == "group":
        want, want_len = jaug.speed_perturb_group(
            jnp.asarray(waves), jnp.asarray(lengths), speeds)
        got, got_len = paug.speed_perturb_group(
            torch.from_numpy(waves), _t(lengths, torch.int64), speeds)
        assign = [0.9] * 3 + [1.0] * 2 + [1.1] * 2
    else:
        choice = jax.random.randint(KEY, (len(waves),), 0, len(speeds))
        want, want_len = jaug.speed_perturb_batch(
            KEY, jnp.asarray(waves), jnp.asarray(lengths), speeds)
        got, got_len = paug.speed_perturb_batch(
            torch.from_numpy(waves), _t(lengths, torch.int64),
            _t(choice, torch.int64), speeds)
        assign = [speeds[int(c)] for c in np.asarray(choice)]
        assert len(set(assign)) == 3
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)
    out = got.numpy()
    for i, sp in enumerate(assign):
        host = audio.speed_perturb(waves[i, :lengths[i]], sp)
        assert int(got_len[i]) == len(host)
        np.testing.assert_allclose(out[i, :len(host)], host, atol=2.0)
        assert np.all(out[i, len(host):] == 0.0)


# -- the matmul DFT ----------------------------------------------------------


def test_matmul_fft_matches_numpy_and_jax(rng):
    """(a, b) = (16, 12): the half-grid product that reverb runs (the
    signal's half spectrum times a filter's, then the half inverse) is
    the circular convolution, 1e-3 abs against numpy in float64 and
    1e-4 abs against JAX's at the same (a, b); the host spectrum layout
    equals JAX's."""
    fft = paug.MatmulFFT(16, 12)
    ref = jaug.MatmulFFT(16, 12, precision="highest")
    x = rng.standard_normal((3, fft.n)).astype(np.float32)
    h = rng.standard_normal((3, fft.n)).astype(np.float32)
    hs = fft.spectrum_mat_half(h)
    hre, him = hs.real.copy(), hs.imag.copy()
    xm = x.reshape(3, 16, 12)
    wre, wim = fft.rfft_mat(torch.from_numpy(xm))
    got = fft.irfft_mat_real(wre * torch.from_numpy(hre)
                             - wim * torch.from_numpy(him),
                             wre * torch.from_numpy(him)
                             + wim * torch.from_numpy(hre))
    want = np.fft.ifft(np.fft.fft(x.astype(np.float64))
                       * np.fft.fft(h.astype(np.float64))).real
    np.testing.assert_allclose(got.numpy().reshape(3, -1), want, atol=1e-3)
    jre, jim = ref.rfft_mat(jnp.asarray(xm))
    jgot = ref.irfft_mat_real(jre * hre - jim * him, jre * him + jim * hre)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-4)
    np.testing.assert_array_equal(fft.spectrum_mat(x), ref.spectrum_mat(x))
    with pytest.raises(ValueError, match="even a"):
        paug.MatmulFFT(15, 12)


@pytest.mark.parametrize("a,b", [(320, 4), (16, 12), (256, 6)])
def test_rfft_half_spectrum_round_trip(rng, a, b):
    """The Hermitian half grid: the same ``ah`` and half-spectrum rows
    as JAX's; ``rfft_mat`` 2e-3 abs against numpy on the kept rows and
    1e-4 against JAX's; ``irfft_mat_real`` of the staged half spectrum
    returns the signal (2e-4), also where ``ah`` has surplus rows."""
    fft = paug.MatmulFFT(a, b)
    ref = jaug.MatmulFFT(a, b, precision="highest")
    assert (fft.ah, fft.nh) == (ref.ah, ref.nh)
    x = rng.standard_normal((2, fft.n)).astype(np.float32)
    xm = x.reshape(2, a, b)
    re, im = fft.rfft_mat(torch.from_numpy(xm))
    jre, jim = ref.rfft_mat(jnp.asarray(xm))
    keep = min(fft.ah, a // 2 + 1)
    want = fft.spectrum_mat(x)
    for got, w, j in ((re, want.real, jre), (im, want.imag, jim)):
        np.testing.assert_allclose(got.numpy()[:, :keep], w[:, :keep],
                                   atol=2e-3)
        np.testing.assert_allclose(got.numpy()[:, :keep],
                                   np.asarray(j)[:, :keep], atol=1e-4)
    half = fft.spectrum_mat_half(x)
    np.testing.assert_array_equal(half, ref.spectrum_mat_half(x))
    back = fft.irfft_mat_real(torch.from_numpy(half.real.copy()),
                              torch.from_numpy(half.imag.copy()))
    np.testing.assert_allclose(back.numpy(), xm, atol=2e-4)


@pytest.mark.parametrize("n", [39555, 3399, 9000, 9399, 9191, 4644])
def test_dft_grid_choice_equals_jax(n):
    """``for_length`` chooses JAX's (a, b) at every utterance + RIR
    length the tests and phase 18f use: 40,960 = 320 x 128 at the
    flagship's 35,556 + 4,000 - 1."""
    got, want = paug.MatmulFFT.for_length(n), jaug.MatmulFFT.for_length(n)
    assert (got.a, got.b, got.ah) == (want.a, want.b, want.ah)
    if n == 39555:
        assert (got.a, got.b) == (320, 128)


# -- reverb ------------------------------------------------------------------


@pytest.mark.parametrize("s,r", [(3000, 400), (9000, 400), (8192, 1000)])
@pytest.mark.parametrize("prob", [0.6, 1.0])
def test_reverb_matches_jax_and_host(rng, prob, s, r):
    """Four rows, three RIRs, JAX's picks and coin flips at prob 0.6
    (some rows reverbed, some not) and 1.0 (every row, no coin): 1e-2
    abs against JAX; each reverbed row against ``np.convolve`` in
    float64 (0.1 abs, the JAX suite's), each other row unchanged; zero
    past each length."""
    b = 4
    waves = (rng.standard_normal((b, s)) * 1000).astype(np.float32)
    lengths = np.asarray([s, s - 777, s, s - 31], np.int32)
    for i in range(b):
        waves[i, lengths[i]:] = 0.0
    rirs = unit_rirs(rng, 3, r)
    fft = paug.MatmulFFT.for_length(s + r - 1)
    ref = jaug.MatmulFFT.for_length(s + r - 1, precision="highest")
    sre, sim = spectra(fft, rirs)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    pick = np.asarray(jax.random.randint(k1, (b,), 0, 3))
    applied = np.asarray(jax.random.uniform(k2, (b,))) < prob
    assert applied.any() and (prob >= 1.0) == applied.all()
    want = jaug.reverb_batch(key, jnp.asarray(waves), jnp.asarray(lengths),
                             ref, jnp.asarray(sre), jnp.asarray(sim), 3, prob)
    got = paug.reverb_batch(torch.from_numpy(waves),
                            _t(lengths, torch.int64), fft,
                            torch.from_numpy(sre), torch.from_numpy(sim),
                            _t(pick, torch.int64),
                            _t(jax.random.uniform(k2, (b,))), prob)
    out = got.numpy()
    np.testing.assert_allclose(out, np.asarray(want), atol=1e-2)
    for i in range(b):
        if not applied[i]:
            np.testing.assert_array_equal(out[i], waves[i])
            continue
        n = lengths[i]
        expected = np.convolve(waves[i].astype(np.float64),
                               rirs[pick[i]].astype(np.float64))[:n]
        np.testing.assert_allclose(out[i, :n], expected, atol=0.1)
        assert np.all(out[i, n:] == 0.0)


@pytest.mark.parametrize("prob", [0.0, 0.5])
def test_reverb_prob_zero_is_identity(rng, prob):
    """prob 0, or every row's coin at or above prob, returns the waves
    as they were, bit for bit (the JAX suite's
    test_reverb_prob_zero_is_identity)."""
    s = 1000
    wave = (rng.standard_normal((2, s)) * 1000).astype(np.float32)
    fft = paug.MatmulFFT.for_length(s + 99)
    sre, sim = spectra(fft, unit_rirs(rng, 1, 100))
    got = paug.reverb_batch(torch.from_numpy(wave), torch.tensor([s, s - 5]),
                            fft, torch.from_numpy(sre), torch.from_numpy(sim),
                            torch.zeros(2).long(), torch.tensor([0.5, 0.99]),
                            prob)
    np.testing.assert_array_equal(got.numpy(), wave)


# -- noise -------------------------------------------------------------------


@pytest.mark.parametrize("noise_len", [2000, 700])
def test_mix_noise_matches_jax_and_host(rng, noise_len):
    """Three rows, two noise clips (tiled to the row width the
    ``np.resize`` way where shorter), per-row SNR ranges, prob 0.7 with
    JAX's draws: 1e-4 rel + 0.05 abs against JAX and against the host
    formula; rows without noise unchanged."""
    s, b = 2000, 3
    waves = (rng.standard_normal((b, s)) * 800).astype(np.float32)
    lengths = np.full((b,), s, np.int32)
    clips = [(rng.standard_normal(noise_len) * 300).astype(np.float32)
             for _ in range(2)]
    rows = np.stack([np.resize(c, (s,)) for c in clips]).astype(np.float32)
    lo = np.asarray([0.0, 5.0], np.float32)
    hi = np.asarray([15.0, 30.0], np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jaug.mix_noise_batch(
        key, jnp.asarray(waves), jnp.asarray(lengths), jnp.asarray(rows),
        jnp.asarray(lo), jnp.asarray(hi), n_rows=2, prob=0.7,
        power_scale=SCALE, precision="highest"))
    k1, k3, k4 = jax.random.split(key, 3)
    pick = np.asarray(jax.random.randint(k1, (b,), 0, 2))
    snr_u = np.asarray(jax.random.uniform(k3, (b,)))
    apply_u = np.asarray(jax.random.uniform(k4, (b,)))
    got = paug.mix_noise_batch(
        torch.from_numpy(waves), _t(lengths, torch.int64),
        torch.from_numpy(rows), torch.from_numpy(lo), torch.from_numpy(hi),
        _t(pick, torch.int64), _t(snr_u), _t(apply_u), 0.7,
        SCALE).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.05)
    assert (apply_u < 0.7).any()
    for i in range(b):
        if apply_u[i] >= 0.7:
            np.testing.assert_array_equal(got[i], waves[i])
            continue
        snr = lo[pick[i]] + snr_u[i] * (hi[pick[i]] - lo[pick[i]])
        np.testing.assert_allclose(
            got[i], host_noise_mix(waves[i], rows[pick[i]], snr),
            rtol=1e-4, atol=0.05)


# -- the staged banks --------------------------------------------------------


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """A noise store (noise_* and music_* keys) and an RIR store of
    wavs written by the port's ``audio.write_wav`` and packed by its
    ``make_blob``, under ``<root>/data`` as the noisy recipe's."""
    root = tmp_path_factory.mktemp("aug_stores")
    rng = np.random.default_rng(11)
    data = root / "data"
    data.mkdir()
    for corpus, items in (
            ("noise", [("noise_0", 1500), ("music_1", 900),
                       ("noise_2", 2600)]),
            ("rir", [("rir_0", 300), ("rir_1", 250)])):
        scp = []
        for key, n in items:
            amp = 0.1 if corpus == "rir" else 0.05
            p = data / f"{key}.wav"
            audio.write_wav(str(p), (amp * rng.standard_normal(n)).astype(
                np.float32), 16000)
            scp.append(f"{key} {p}")
        (data / f"{corpus}.scp").write_text("\n".join(scp) + "\n")
        make_blob(str(data / f"{corpus}.scp"), str(data / f"{corpus}_store"))
    return root


AUG_CONF = {"speed_perturb": True,
            "noise_prob": 0.8, "noise_source": "data/noise_store",
            "reverb_prob": 0.5, "reverb_source": "data/rir_store"}


@pytest.mark.parametrize("block_dft", [False, True])
def test_from_conf_stages_jax_banks(stores, block_dft, caplog):
    """``from_conf`` on the port's stores: the noise rows (3 clips x 8
    crops), SNR ranges by key prefix, RIR half spectra, the DFT grid
    and the probabilities equal JAX's staging of the same stores (its
    banks' first n_rows rows; the port does not pad to 512).  With
    ``reverb_block_dft: true``, at a width where JAX would take its
    overlap-save grid, the port logs that the knob is ignored and
    stages JAX's full-utterance banks (ROADMAP C.15)."""
    width = 20000 if block_dft else 2000
    with caplog.at_level("INFO"):
        got = paug.DeviceWaveAug.from_conf(
            dict(AUG_CONF, reverb_block_dft=block_dft),
            max_wave_samples=width, data_dir=str(stores), device="cpu")
    assert ("reverb_block_dft is ignored" in caplog.text) == block_dft
    want = jaug.DeviceWaveAug.from_conf(
        dict(AUG_CONF, reverb_block_dft=False), max_wave_samples=width,
        data_dir=str(stores), precision="highest", dtype="float32")
    assert got.n_noise_rows == want.n_noise_rows == 24
    assert got.n_rirs == want.n_rirs == 2
    assert want.rir_len == 0 and not hasattr(got, "rir_len")
    assert (got.fft.a, got.fft.b, got.fft.n) == (want.fft.a, want.fft.b,
                                                 want.fft.n)
    assert got.noise_rows.shape == (24, int(np.ceil(width / 0.9)))
    for name, n in (("noise_rows", 24), ("snr_lo", 24), ("snr_hi", 24),
                    ("rir_re", 2), ("rir_im", 2)):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name))[:n],
                                      err_msg=name)
    np.testing.assert_array_equal(got.snr_lo.numpy()[::8], [0, 5, 0])
    assert (got.reverb_prob, got.noise_prob, got.power_scale) == (
        want.reverb_prob, want.noise_prob, want.power_scale)
    assert got.speed_perturb and got.speeds == want.speeds


def test_from_conf_skips_stages_without_source(stores):
    """As JAX's: a probability without a source skips the stage; the
    chain then draws nothing for it."""
    conf = {"speed_perturb": False, "noise_prob": 0.5, "reverb_prob": 0.5}
    got = paug.DeviceWaveAug.from_conf(conf, 1000, data_dir=str(stores),
                                       device="cpu")
    want = jaug.DeviceWaveAug.from_conf(conf, 1000, data_dir=str(stores))
    assert got.rir_re is None and want.rir_re is None
    assert got.noise_rows is None and want.noise_rows is None
    gen = torch.Generator().manual_seed(0)
    assert got.draws(4, gen) == {}
    waves = torch.randn(4, 1000)
    out, lens = got(waves, torch.full((4,), 1000), gen)
    assert torch.equal(out, waves) and lens.tolist() == [1000] * 4


def small_augs(rng):
    """One chain for both packages from the same numpy banks: reverb
    on one full-utterance DFT (three 200-tap RIRs), three noise rows,
    speeds 0.9-1.1 (by row group from 3 rows, else per row)."""
    out_len = int(np.ceil(4000 / 0.9))
    rirs = unit_rirs(rng, 3, 200)
    rows = (rng.standard_normal((3, out_len)) * 200).astype(np.float32)
    lo = np.asarray([0.0, 5.0, 5.0], np.float32)
    hi = np.asarray([15.0, 30.0, 15.0], np.float32)
    ref = jaug.MatmulFFT.for_length(out_len + 200 - 1, precision="highest")
    fft = paug.MatmulFFT.for_length(out_len + 200 - 1)
    sre, sim = spectra(fft, rirs)
    common = dict(speed_perturb=True, speeds=(0.9, 1.0, 1.1),
                  reverb_prob=0.5, noise_prob=0.7, power_scale=SCALE)
    want = jaug.DeviceWaveAug(
        fft=ref, rir_re=jnp.asarray(sre), rir_im=jnp.asarray(sim), n_rirs=3,
        noise_rows=jnp.asarray(rows), snr_lo=jnp.asarray(lo),
        snr_hi=jnp.asarray(hi), n_noise_rows=3, precision="highest",
        speed_method="conv", speed_partition=True, **common)
    got = paug.DeviceWaveAug(
        fft=fft, rir_re=torch.from_numpy(sre), rir_im=torch.from_numpy(sim),
        noise_rows=torch.from_numpy(rows), snr_lo=torch.from_numpy(lo),
        snr_hi=torch.from_numpy(hi), **common)
    return got, want


def chain_rows(rng, b=8):
    """``b`` (at most 8) rows of 4,000 samples, ragged, zero past each
    length."""
    waves = (rng.standard_normal((8, 4000)) * 500).astype(np.float32)[:b]
    lengths = np.asarray([3517, 4000, 3900, 4000, 4000, 2000, 4000, 4000],
                         np.int32)[:b]
    for i in range(b):
        waves[i, lengths[i]:] = 0.0
    return waves, lengths


@pytest.mark.parametrize("b", [8, 2])
def test_device_wave_aug_matches_jax(rng, b):
    """The whole chain (speed, reverb, noise) with JAX's draws,
    speeds by row group (8 rows) and per row (2 rows, fewer than the
    speeds): new lengths exact, waves 1e-2 abs + 1e-4 rel (noise is
    scaled by the row's power, so the speed stage's error scales)."""
    got_aug, want_aug = small_augs(rng)
    waves, lengths = chain_rows(rng, b)
    key = jax.random.PRNGKey(7)
    want, want_len = want_aug(key, jnp.asarray(waves), jnp.asarray(lengths))
    draws = jax_draws(key, b, want_aug)
    assert ("choice" in draws) == (b < 3)
    assert set(draws) == set(got_aug.draws(b, torch.Generator()))
    got, got_len = got_aug.apply(torch.from_numpy(waves),
                                 _t(lengths, torch.int64), draws)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2,
                               rtol=1e-4)
    assert got.shape == (b, int(np.ceil(4000 / 0.9)))


def test_draws_order_and_device_generator():
    """The documented order and count: per-row speed choice (fewer rows
    than speeds), RIR pick and coin, noise pick, SNR and coin, each
    (B,), from one generator; the same seed gives the same draws."""
    aug, _ = small_augs(np.random.default_rng(0))
    one = aug.draws(2, torch.Generator().manual_seed(3))
    assert list(one) == ["choice", "rir_pick", "rir_apply_u", "noise_pick",
                         "snr_u", "noise_apply_u"]
    gen = torch.Generator().manual_seed(3)
    want = [torch.randint(0, 3, (2,), generator=gen),
            torch.randint(0, 3, (2,), generator=gen),
            torch.rand((2,), generator=gen),
            torch.randint(0, 3, (2,), generator=gen),
            torch.rand((2,), generator=gen),
            torch.rand((2,), generator=gen)]
    for got, w in zip(one.values(), want):
        assert torch.equal(got, w)
    assert list(aug.draws(5, torch.Generator()))[0] == "rir_pick"


class Injected:
    """A wave_aug that applies ``aug`` with fixed draws."""

    def __init__(self, aug, draws):
        self.aug, self.draws, self.calls = aug, draws, 0

    def __call__(self, waves, lengths, generator):
        self.calls += 1
        return self.aug.apply(waves, lengths, self.draws)


def test_pipeline_with_wave_aug_matches_jax(rng):
    """``DeviceFeaturePipeline`` with the chain attached against JAX's
    pipeline with its own (dither 0, no spec_aug; JAX's draws from
    ``fold_in(rng, 0x77)``): feature lengths exact and following the
    speed-perturbed lengths, features 1e-3 abs + 1e-4 rel; without a
    generator (a cv call) the waves are not augmented."""
    got_aug, want_aug = small_augs(rng)
    waves, lengths = chain_rows(rng)
    jp = JaxPipeline.from_conf(FBANK_CONF, training=True)
    jp.wave_aug = want_aug
    rng_j = jax.random.PRNGKey(9)
    want, want_len = jp(jnp.asarray(waves), jnp.asarray(lengths), rng_j)
    pp = DeviceFeaturePipeline.from_conf(FBANK_CONF, training=True)
    pp.wave_aug = Injected(got_aug, jax_draws(
        jax.random.fold_in(rng_j, 0x77), 8, want_aug))
    got, got_len = pp(torch.from_numpy(waves), _t(lengths, torch.int64),
                      generator=torch.Generator().manual_seed(0))
    assert pp.wave_aug.calls == 1
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    base = pp.feat_lengths(_t(lengths, torch.int64))
    assert (got_len[:3] > base[:3]).all()  # rows 0-2 at speed 0.9
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-4)
    plain, plain_len = pp(torch.from_numpy(waves), _t(lengths, torch.int64))
    assert pp.wave_aug.calls == 1 and torch.equal(plain_len, base)


# -- the resident step -------------------------------------------------------


TRAIN_CONF = dict(FBANK_CONF, spec_aug=True, spec_aug_conf={
    "num_t_mask": 1, "num_f_mask": 1, "max_t": 10, "max_f": 5})
TRAIN_CONF["fbank_conf"] = dict(FBANK_CONF["fbank_conf"], dither=1.0,
                                dither_mode="wave")
DS_TCN = {"input_dim": 23, "output_dim": 1, "hidden_dim": 16,
          "preprocessing": {"type": "linear"},
          "backbone": {"type": "tcn", "ds": True, "num_layers": 2,
                       "kernel_size": 4, "dropout": 0.0}}


def test_resident_aug_step_is_host_step(rng):
    """A resident step with the chain attached (dither and spec_aug on,
    the augmentation's draws from the step generator) equals
    ``Trainer.train_step`` on the same rows copied to the host, bit for
    bit: loss, accuracy, gradient norm, every parameter and buffer."""
    aug, _ = small_augs(rng)
    n, s = 16, 4000
    waves = np.clip(np.rint(rng.standard_normal((n, s)) * 600), -32768,
                    32767).astype(np.int16)
    arrays = {"waves": waves, "wave_lengths": np.full((n,), s, np.int32),
              "target": (np.arange(n) % 2 - 1).astype(np.int32),
              "target_lengths": np.ones((n,), np.int32)}
    trainer = Trainer(init_model(DS_TCN, torch.Generator().manual_seed(0)),
                      DeviceFeaturePipeline.from_conf(TRAIN_CONF),
                      DeviceFeaturePipeline.from_conf(TRAIN_CONF, False),
                      "max_pooling", grad_clip=5.0, min_duration=5,
                      device="cpu")
    trainer.pipeline.wave_aug = aug
    state = trainer.init_state()
    import copy

    host_state = copy.deepcopy(state)
    corpus = stage_arrays(arrays, device="cpu")
    for rows in corpus.epoch_index(0, 8):
        state, got = trainer.train_step(
            state, gather_rows(corpus.arrays, torch.from_numpy(rows)), 3,
            1e-3)
        host_state, want = trainer.train_step(
            host_state, {k: v[rows] for k, v in arrays.items()}, 3, 1e-3)
        for key in ("loss", "acc", "grad_norm"):
            assert float(got[key]) == float(want[key]), key
    want = host_state.model.state_dict()
    for name, val in state.model.state_dict().items():
        assert torch.equal(val, want[name]), name


def test_bin_train_resident_noisy_recipe_config(stores, monkeypatch):
    """``bin.train --device_resident --device cpu`` on
    examples/synthetic_noisy/conf/ds_tcn_aug.yaml (its relative
    data/noise_store and data/rir_store found from the working
    directory, as the recipe's run), batch size cut to 8: one epoch,
    a ``DeviceWaveAug`` from the config on the train pipeline, applied
    once a step, none on cv."""
    import yaml

    from wekws_tpu_torch.bin import train

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "examples", "synthetic_noisy", "conf",
                           "ds_tcn_aug.yaml")) as f:
        conf = yaml.safe_load(f)
    conf["dataset_conf"]["batch_conf"]["batch_size"] = 8
    root = stores
    monkeypatch.chdir(root)
    (root / "conf.yaml").write_text(yaml.safe_dump(conf))
    wav_dir = os.path.join(repo, "examples", "synthetic", "data")
    for split, n in (("train", 16), ("dev", 8)):
        (root / f"{split}.list").write_text("".join(json.dumps({
            "key": f"{split}_{i}", "txt": "0" if i % 2 == 0 else "-1",
            "wav": os.path.join(wav_dir, split, f"{split}_{i}.wav"),
        }) + "\n" for i in range(n)))
    made, calls = [], []
    from_conf = paug.DeviceWaveAug.from_conf.__func__
    apply = paug.DeviceWaveAug.apply

    def record(cls, *args, **kwargs):
        made.append(from_conf(cls, *args, **kwargs))
        return made[-1]

    def counted(self, *args):
        calls.append(args[0].shape)
        return apply(self, *args)

    monkeypatch.setattr(paug.DeviceWaveAug, "from_conf",
                        classmethod(record))
    monkeypatch.setattr(paug.DeviceWaveAug, "apply", counted)
    train.main(["--config", "conf.yaml", "--train_data", "train.list",
                "--cv_data", "dev.list", "--model_dir", "exp",
                "--min_duration", "20", "--num_epochs", "1",
                "--device_resident", "--device", "cpu"])
    assert len(made) == 1 and len(calls) == 2  # 16 rows, B=8: two steps
    aug = made[0]
    assert aug.speed_perturb and aug.n_noise_rows == 24 and aug.n_rirs == 2
    assert calls[0][0] == 8
    with open(root / "exp" / "metrics.jsonl") as f:
        record_ = json.loads(f.readline())
    assert record_["batches"] == 2 and np.isfinite(record_["train_loss"])
    with open(root / "exp" / "0.yaml") as f:
        assert np.isfinite(float(yaml.safe_load(f)["cv_loss"]))
