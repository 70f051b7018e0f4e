"""Waveform augmentation on the device: speed perturbation, RIR reverb
and additive noise on a gathered batch, inside the train step.

Port of wekws_tpu/data/device_aug.py.  The host pipeline's chain
(data/processor.py: speed_perturb -> add_reverb -> add_noise) runs per
utterance on the host; a device-resident corpus (data/resident.py)
stages raw waves once, so its augmentation runs here, on the card, on
each step's rows.  The noise and RIR banks are staged once as buffers
of ``DeviceWaveAug``.

The math is the JAX package's, in its matrix form:

* speed perturbation: polyphase linear interpolation at the exact
  rational speed p/q, as one ``matmul`` of (B, blocks, p + 2) frames
  with the (p + 2, q) interpolation matrix; new lengths
  ``len * q // p`` on integers (the host's ``audio.speed_perturb``);
  speeds by contiguous row group (``speed_perturb_group``), or per row
  (``speed_perturb_batch``);
* reverb: linear convolution with an L2-normalised RIR through a DFT
  written as matmuls (``MatmulFFT``, four-step Cooley-Tukey in a fixed
  (a, b) layout on the Hermitian half grid), over the whole utterance
  (``reverb_batch``);
* noise: a bank row (clip and crop offset) mixed at an SNR drawn from
  the row's range, with the reference's +1e-4 power floor at the
  [-1, 1) scale (``mix_noise_batch``).

Where the port departs from the JAX package (ROADMAP C.15):

* everything is float32 and relies on the default
  ``torch.backends.cuda.matmul.allow_tf32 = False``; the JAX package's
  ``device_aug_dtype`` / ``device_aug_precision`` (bfloat16 and one
  bf16 pass by default) are accepted and logged once.  No product here
  is a convolution: cuDNN would run it in TF32 unless
  ``torch.backends.cudnn.allow_tf32`` is False;
* bank rows are picked by ``index_select``, not by a one-hot matmul
  (the same numbers at float32: a one-hot product adds exact zeros),
  and the banks are not zero-padded to 512 rows;
* the DFT's last transpose is a transpose, not a product with the
  identity (again the same numbers);
* one reverb path, the full-utterance DFT: ``reverb_block_dft``
  (overlap-save blocks, the same linear convolution) is ignored, and
  only the Hermitian half grid is built (no full-grid transform);
* no ``leaves``/``bind``: the step is eager.

Random draws are separate from the arithmetic: each stage takes its
draws as tensors (``choice``, ``pick``, ``apply_u``, ``snr_u``), so a
test can inject the JAX package's.  ``DeviceWaveAug.draws`` takes them
from the step's generator in a fixed order (see there).
"""

import logging
import os
from fractions import Fraction
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wekws_tpu_torch.device import resolve_device

_INT16 = float(1 << 15)
SPEEDS = (0.9, 1.0, 1.1)


def _rational(speed: float) -> Tuple[int, int]:
    frac = Fraction(speed).limit_denominator(100)
    return frac.numerator, frac.denominator


# ---------------------------------------------------------------------------
# speed perturbation: polyphase resampling
# ---------------------------------------------------------------------------


def _polyphase_matrix(speed: float):
    """(p, q, M (p + 2, q) float32): q output samples per p input
    samples, out[q*k + r] = sum_w M[w, r] * x[p*k + w], linear
    interpolation at the exact rational phases."""
    p, q = _rational(speed)
    w = p + 2  # base_r + 1 <= p - 1 + 1; +1 margin
    m = np.zeros((w, q), np.float32)
    for r in range(q):
        base, rem = divmod(p * r, q)
        f = rem / q
        m[base, r] = 1.0 - f
        m[base + 1, r] = f
    return p, q, m


def speed_matrix(speed: float, device) -> torch.Tensor:
    """``_polyphase_matrix(speed)``'s matrix as a tensor on ``device``."""
    return torch.from_numpy(_polyphase_matrix(speed)[2]).to(device)


def resample_one(waves: torch.Tensor, p: int, q: int, m: torch.Tensor,
                 out_len: int) -> torch.Tensor:
    """Polyphase resample (B, S) -> (B, out_len) at speed p/q.  The
    frames x[p*k + j], j < p, are ``x.reshape(B, blocks, p)``; the two
    taps j = p, p + 1 are the next block's first two columns."""
    b = waves.shape[0]
    blocks = -(-out_len // q)
    need = p * (blocks + 1)
    if waves.shape[1] < need:
        waves = F.pad(waves, (0, need - waves.shape[1]))
    r = waves[:, :need].reshape(b, blocks + 1, p)
    frames = torch.cat([r[:, :blocks, :], r[:, 1:, :2]], dim=2)
    out = torch.matmul(frames, m).reshape(b, blocks * q)
    return out[:, :out_len]


def _speed_lengths(lengths: torch.Tensor, speed: float) -> torch.Tensor:
    p, q = _rational(speed)
    return torch.div(lengths * q, p, rounding_mode="floor")


def _at_speed(waves, speed, out_len, mats):
    """(B, S) float32 -> (B, out_len) at ``speed``, unmasked."""
    s = waves.shape[1]
    if speed == 1.0:
        return F.pad(waves, (0, max(0, out_len - s)))[:, :out_len]
    p, q = _rational(speed)
    m = mats.get(speed) if mats else None
    if m is None:
        m = speed_matrix(speed, waves.device)
    return resample_one(waves, p, q, m, out_len)


def speed_perturb_group(
    waves: torch.Tensor,
    lengths: torch.Tensor,
    speeds: Tuple[float, ...] = SPEEDS,
    out_len: Optional[int] = None,
    mats: Optional[Dict[float, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) -> (B, out_len): speed by contiguous row group (rows
    [0, B/k) get speeds[0], ...; the remainder rows go to the early
    groups), each group resampled at its own speed only.  The epoch
    shuffle makes each utterance's speed uniform over ``speeds`` across
    epochs.  Draws nothing.  ``mats``: the interpolation matrices by
    speed, on the waves' device (made here where missing)."""
    b, s = waves.shape
    k = len(speeds)
    if out_len is None:
        out_len = int(np.ceil(s / min(speeds)))
    base, rem = divmod(b, k)
    cols = torch.arange(out_len, device=waves.device)
    outs, lens = [], []
    start = 0
    for i, sp in enumerate(speeds):
        g = base + (1 if i < rem else 0)
        seg = waves[start:start + g].to(torch.float32)
        seglen = lengths[start:start + g]
        cand = _at_speed(seg, sp, out_len, mats)
        nl = seglen if sp == 1.0 else _speed_lengths(seglen, sp)
        outs.append(cand * (cols[None, :] < nl[:, None]))
        lens.append(nl)
        start += g
    return torch.cat(outs, dim=0), torch.cat(lens)


def speed_perturb_batch(
    waves: torch.Tensor,
    lengths: torch.Tensor,
    choice: torch.Tensor,
    speeds: Tuple[float, ...] = SPEEDS,
    out_len: Optional[int] = None,
    mats: Optional[Dict[float, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) -> (B, out_len) at the speed ``speeds[choice[i]]`` for
    row i: every speed is resampled for every row and the row's one
    selected."""
    b, s = waves.shape
    if out_len is None:
        out_len = int(np.ceil(s / min(speeds)))
    new_len = lengths
    for i, sp in enumerate(speeds):
        new_len = torch.where(choice == i, _speed_lengths(lengths, sp),
                              new_len)
    w = waves.to(torch.float32)
    out = None
    for i, sp in enumerate(speeds):
        cand = _at_speed(w, sp, out_len, mats)
        out = cand if out is None else torch.where(
            (choice == i)[:, None], cand, out)
    cols = torch.arange(out_len, device=waves.device)
    return out * (cols[None, :] < new_len[:, None]), new_len


# ---------------------------------------------------------------------------
# matmul DFT (fixed (a, b) matrix layout)
# ---------------------------------------------------------------------------


class MatmulFFT(nn.Module):
    """Two-factor (four-step Cooley-Tukey) DFT of a real signal as
    matmuls, in a fixed (a, b) matrix layout for both directions.  For
    n = a*b, time index n = b*n1 + n2 and frequency index k = k1 + a*k2:

        X[k1, k2] = sum_{n2} W_n^{n2 k1} W_b^{n2 k2}
                    sum_{n1} x[n1, n2] W_a^{n1 k1}

    Complex numbers are real/imaginary pairs.  The matrices are float64
    numpy rounded to float32, held as buffers.

    Hermitian half grid (real input): X[n-k] = conj(X[k]); in the
    (k1, k2) layout the mirror of row k1 is row a-k1, so the rows
    k1 in [0, a/2] carry the whole spectrum.  ``ah`` keeps a/2 + 1 rows
    rounded up to a multiple of 64 (at most a), the JAX package's
    layout; the inverse weights count row 0 and the Nyquist row once,
    the other kept rows twice and the surplus rows zero, so the half
    inverse is exact.  ``a`` must be even."""

    def __init__(self, a: int, b: int, device=None):
        super().__init__()
        if a % 2:
            raise ValueError(f"the half grid needs an even a, got {a}")
        self.a, self.b, self.n = a, b, a * b
        wa = np.exp(-2j * np.pi * np.outer(np.arange(a), np.arange(a)) / a)
        wb = np.exp(-2j * np.pi * np.outer(np.arange(b), np.arange(b)) / b)
        tw = np.exp(-2j * np.pi
                    * np.outer(np.arange(a), np.arange(b)) / self.n)

        def reg(name, x):
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(x, np.float32)).to(device),
                persistent=False)

        self.ah = min(a, 64 * (-(-(a // 2 + 1) // 64)))
        wgt = np.zeros((self.ah,), np.float64)
        wgt[0] = 1.0
        wgt[1:a // 2] = 2.0
        wgt[a // 2] = 1.0
        reg("wb_re", wb.real)
        reg("wb_im", wb.imag)
        reg("wah_re", wa.real[:, :self.ah])
        reg("wah_im", wa.imag[:, :self.ah])
        reg("twTh_re", tw.real.T[:, :self.ah])
        reg("twTh_im", tw.imag.T[:, :self.ah])
        # conjugates for the inverse
        reg("wbc_re", wb.real)
        reg("wbc_im", -wb.imag)
        reg("twh_re", tw.real[:self.ah])
        reg("twh_im", tw.imag[:self.ah])
        reg("wach_re", wa.real.T[:self.ah] * wgt[:, None])
        reg("wach_im", -wa.imag.T[:self.ah] * wgt[:, None])

    @property
    def nh(self) -> int:
        """Flattened half-spectrum width (ah * b)."""
        return self.ah * self.b

    @staticmethod
    def _swap(xre, xim, wre, wim, imag: bool = True):
        """Contract dim 1 of (B, u, v) against (u, u') -> (B, v, u')."""
        def dg(x, w):
            return torch.matmul(x.transpose(1, 2), w)

        ore = dg(xre, wre)
        if xim is not None:
            ore = ore - dg(xim, wim)
        if not imag:
            return ore, None
        oim = dg(xre, wim)
        if xim is not None:
            oim = oim + dg(xim, wre)
        return ore, oim

    @staticmethod
    def _minor(xre, xim, wre, wim):
        """Contract the minor dim of (B, u, v) against (v, v') ->
        (B, u, v')."""
        return (torch.matmul(xre, wre) - torch.matmul(xim, wim),
                torch.matmul(xre, wim) + torch.matmul(xim, wre))

    def rfft_mat(self, x):
        """Real (B, a, b) [n1, n2] -> half spectrum (B, ah, b) [k1, k2];
        rows k1 >= a/2 + 1 unspecified (zero inverse weight)."""
        tre, tim = self._swap(x, None, self.wah_re, self.wah_im)
        tre, tim = (tre * self.twTh_re - tim * self.twTh_im,
                    tre * self.twTh_im + tim * self.twTh_re)
        return self._swap(tre, tim, self.wb_re, self.wb_im)

    def irfft_mat_real(self, xre, xim):
        """(B, ah, b) half spectrum -> (B, a, b) real [n1, n2], exact
        for Hermitian data (the mirror rows folded in as 2x weights)."""
        tre, tim = self._minor(xre, xim, self.wbc_re, self.wbc_im)
        tre, tim = (tre * self.twh_re + tim * self.twh_im,
                    tim * self.twh_re - tre * self.twh_im)
        ore, _ = self._swap(tre, None, self.wach_re, None, imag=False)
        oim, _ = self._swap(tim, None, self.wach_im, None, imag=False)
        z = (ore - oim) / self.n          # (B, n2, n1)
        return z.transpose(1, 2)          # (B, n1, n2)

    def spectrum_mat(self, x: np.ndarray) -> np.ndarray:
        """Host side: np.fft.fft(x, n) in the [k1, k2] layout
        (k = k1 + a*k2 -> reshape (b, a), swap axes)."""
        flat = np.fft.fft(x, self.n, axis=-1)
        return np.swapaxes(
            flat.reshape(x.shape[:-1] + (self.b, self.a)), -1, -2)

    def spectrum_mat_half(self, x: np.ndarray) -> np.ndarray:
        """Host side: ``spectrum_mat`` cut to the kept ``ah`` rows, the
        surplus rows zero."""
        full = self.spectrum_mat(x)
        half = np.zeros(x.shape[:-1] + (self.ah, self.b), np.complex64)
        keep = min(self.ah, self.a // 2 + 1)
        half[..., :keep, :] = full[..., :keep, :]
        return half

    @classmethod
    def for_length(cls, min_n: int, device=None) -> "MatmulFFT":
        """The JAX package's choice: the smallest n = a*b >= min_n with
        a in (256, 320, 384, 512) and b a multiple of 128, where that
        costs at most 25% more than a = 256, b = ceil(min_n / 256);
        else the latter."""
        best = None
        for a in (256, 320, 384, 512):
            b = 128 * -(-min_n // (a * 128))
            if best is None or a * b < best[0] * best[1]:
                best = (a, b)
        unaligned = (256, -(-min_n // 256))
        if best[0] * best[1] <= 1.25 * unaligned[0] * unaligned[1]:
            return cls(best[0], best[1], device)
        return cls(unaligned[0], unaligned[1], device)


# ---------------------------------------------------------------------------
# reverb
# ---------------------------------------------------------------------------


def _valid(lengths: torch.Tensor, s: int) -> torch.Tensor:
    return torch.arange(s, device=lengths.device)[None, :] < lengths[:, None]


def reverb_batch(
    waves: torch.Tensor,
    lengths: torch.Tensor,
    fft: MatmulFFT,
    rir_re: torch.Tensor,  # (R, ah*b) half-spectrum rows
    rir_im: torch.Tensor,
    pick: torch.Tensor,     # (B,) RIR rows
    apply_u: torch.Tensor,  # (B,) uniform [0, 1): reverb where < prob
    prob: float,
) -> torch.Tensor:
    """Convolve row i with RIR ``pick[i]`` where ``apply_u[i] < prob``
    (every row at prob >= 1), through one full-utterance DFT; the
    output is cut to the input and zero past each length."""
    assert rir_re.shape[1] == fft.nh, (rir_re.shape, fft.nh)
    mask = _valid(lengths, waves.shape[1])
    out = _reverb_rows(waves, fft, rir_re, rir_im, pick) * mask
    if prob >= 1.0:
        return out
    return torch.where((apply_u < prob)[:, None], out, waves)


def _reverb_rows(waves, fft, rir_re, rir_im, pick):
    """Every row DFT-convolved with its RIR (no probability, no mask)."""
    b, s = waves.shape
    rre = rir_re.index_select(0, pick).reshape(b, fft.ah, fft.b)
    rim = rir_im.index_select(0, pick).reshape(b, fft.ah, fft.b)
    x = F.pad(waves.to(torch.float32), (0, fft.n - s)).reshape(
        b, fft.a, fft.b)
    wre, wim = fft.rfft_mat(x)
    pre = wre * rre - wim * rim
    pim = wre * rim + wim * rre
    return fft.irfft_mat_real(pre, pim).reshape(b, fft.n)[:, :s]


# ---------------------------------------------------------------------------
# additive noise
# ---------------------------------------------------------------------------


def mix_noise_batch(
    waves: torch.Tensor,
    lengths: torch.Tensor,
    noise_rows: torch.Tensor,  # (N, >= S): clips at their crop offsets
    snr_lo: torch.Tensor,      # (N,) each row's SNR range
    snr_hi: torch.Tensor,
    pick: torch.Tensor,        # (B,) bank rows
    snr_u: torch.Tensor,       # (B,) uniform [0, 1): where in the range
    apply_u: torch.Tensor,     # (B,) uniform [0, 1): noise where < prob
    prob: float,
    power_scale: float = 1.0,
) -> torch.Tensor:
    """Add bank row ``pick[i]`` to row i at an SNR of
    ``lo + snr_u * (hi - lo)`` dB where ``apply_u[i] < prob``.  Powers
    are means over the valid samples; ``power_scale`` takes the waves'
    scale to the [-1, 1) scale for which the reference's +1e-4 power
    floor was chosen."""
    b, s = waves.shape
    noise = noise_rows.index_select(0, pick)[:, :s].to(torch.float32)
    mask = _valid(lengths, s).to(torch.float32)
    n_valid = torch.clamp(lengths.to(torch.float32), min=1.0)
    ps = float(np.float32(power_scale)) ** 2
    waves_f = waves.to(torch.float32)
    audio_pow = torch.sum(waves_f * waves_f * mask, dim=1) / n_valid * ps
    noise_pow = torch.sum(noise * noise * mask, dim=1) / n_valid * ps
    audio_db = 10.0 * torch.log10(audio_pow + 1e-4)
    noise_db = 10.0 * torch.log10(noise_pow + 1e-4)
    lo = snr_lo.index_select(0, pick)
    snr = snr_u * (snr_hi.index_select(0, pick) - lo) + lo
    scale = torch.sqrt(torch.pow(10.0, (audio_db - noise_db - snr) / 10.0))
    scale = torch.where(apply_u < prob, scale, torch.zeros_like(scale))
    return waves + scale[:, None] * noise * mask


# ---------------------------------------------------------------------------
# the staged banks
# ---------------------------------------------------------------------------


class DeviceWaveAug(nn.Module):
    """The staged banks and probabilities;
    ``(waves, lengths, generator) -> (waves, lengths)`` runs the host
    chain's order: speed perturbation, reverb, noise.  The banks are
    buffers (``.to(device)`` moves them); ``rir_re``/``rir_im`` hold
    each RIR's half spectrum on ``fft``'s grid, ``noise_rows`` each
    noise clip at its crop offsets, ``snr_lo``/``snr_hi`` each row's
    SNR range in dB.  A stage whose bank is None, or whose probability
    is 0, is skipped.  Speeds go
    by row group (no draw) where the batch has at least one row a
    speed, else per row (the JAX package's default,
    ``speed_partition=True``)."""

    def __init__(
        self,
        speed_perturb: bool,
        speeds: Tuple[float, ...] = SPEEDS,
        fft: Optional[MatmulFFT] = None,
        rir_re: Optional[torch.Tensor] = None,
        rir_im: Optional[torch.Tensor] = None,
        reverb_prob: float = 0.0,
        noise_rows: Optional[torch.Tensor] = None,
        snr_lo: Optional[torch.Tensor] = None,
        snr_hi: Optional[torch.Tensor] = None,
        noise_prob: float = 0.0,
        power_scale: float = 1.0 / _INT16,
    ):
        super().__init__()
        self.speed_perturb = bool(speed_perturb)
        self.speeds = tuple(speeds)
        self.fft = fft
        self.register_buffer("rir_re", rir_re, persistent=False)
        self.register_buffer("rir_im", rir_im, persistent=False)
        self.register_buffer("noise_rows", noise_rows, persistent=False)
        self.register_buffer("snr_lo", snr_lo, persistent=False)
        self.register_buffer("snr_hi", snr_hi, persistent=False)
        self.reverb_prob = float(reverb_prob)
        self.noise_prob = float(noise_prob)
        self.power_scale = float(power_scale)
        dev = next((t.device for t in (rir_re, noise_rows)
                    if t is not None), torch.device("cpu"))
        self._speed_keys = {}
        for i, sp in enumerate(self.speeds):
            if sp != 1.0:
                name = f"speed_mat{i}"
                self.register_buffer(name, speed_matrix(sp, dev),
                                     persistent=False)
                self._speed_keys[sp] = name

    @property
    def n_rirs(self) -> int:
        return 0 if self.rir_re is None else int(self.rir_re.shape[0])

    @property
    def n_noise_rows(self) -> int:
        return 0 if self.noise_rows is None else int(
            self.noise_rows.shape[0])

    @property
    def reverb_on(self) -> bool:
        return self.rir_re is not None and self.reverb_prob > 0

    @property
    def noise_on(self) -> bool:
        return self.noise_rows is not None and self.noise_prob > 0

    def grouped(self, b: int) -> bool:
        return b >= len(self.speeds)

    def mats(self) -> Dict[float, torch.Tensor]:
        return {sp: getattr(self, name)
                for sp, name in self._speed_keys.items()}

    def draws(self, b: int, generator: torch.Generator
              ) -> Dict[str, torch.Tensor]:
        """One call's random draws for ``b`` rows, on the generator's
        device, in this order: the speed ``choice`` (per-row speeds
        only); the RIR ``rir_pick`` and ``rir_apply_u`` (reverb on);
        the noise ``noise_pick``, ``snr_u`` and ``noise_apply_u`` (noise
        on).  A stage that is off draws nothing."""
        dev = generator.device
        out = {}

        def randint(high):
            return torch.randint(0, high, (b,), generator=generator,
                                 device=dev)

        def uniform():
            return torch.rand((b,), generator=generator, device=dev)

        if self.speed_perturb and not self.grouped(b):
            out["choice"] = randint(len(self.speeds))
        if self.reverb_on:
            out["rir_pick"] = randint(self.n_rirs)
            out["rir_apply_u"] = uniform()
        if self.noise_on:
            out["noise_pick"] = randint(self.n_noise_rows)
            out["snr_u"] = uniform()
            out["noise_apply_u"] = uniform()
        return out

    def apply(self, waves: torch.Tensor, lengths: torch.Tensor,
              draws: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The chain on (B, S) waves with the given draws."""
        waves = waves.to(torch.float32)
        if self.speed_perturb:
            if self.grouped(waves.shape[0]):
                waves, lengths = speed_perturb_group(
                    waves, lengths, self.speeds, mats=self.mats())
            else:
                waves, lengths = speed_perturb_batch(
                    waves, lengths, draws["choice"], self.speeds,
                    mats=self.mats())
        if self.reverb_on:
            waves = reverb_batch(
                waves, lengths, self.fft, self.rir_re, self.rir_im,
                draws["rir_pick"], draws["rir_apply_u"], self.reverb_prob)
        if self.noise_on:
            waves = mix_noise_batch(
                waves, lengths, self.noise_rows, self.snr_lo, self.snr_hi,
                draws["noise_pick"], draws["snr_u"], draws["noise_apply_u"],
                self.noise_prob, self.power_scale)
        return waves, lengths

    def forward(self, waves: torch.Tensor, lengths: torch.Tensor,
                generator: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.apply(waves, lengths,
                          self.draws(waves.shape[0], generator))

    @classmethod
    def from_conf(cls, conf: dict, max_wave_samples: int,
                  wave_scale: float = _INT16, data_dir: str = ".",
                  crop_variants: int = 8, device="cuda"):
        """From a wekws ``dataset_conf`` (speed_perturb, noise_source /
        noise_prob, reverb_source / reverb_prob), the
        banks read from the blob stores (paths relative to
        ``data_dir``) and staged on ``device``.  ``max_wave_samples``
        is the staged waves' width: with speed_perturb the chain's
        output is ceil(width / 0.9) samples, the noise rows' width.
        Each noise clip is staged at ``crop_variants`` circular offsets
        (``np.resize`` tiling), in the waves' scale; RIRs are
        L2-normalised in float64; the spectra are on one full-utterance
        DFT (``reverb_block_dft`` is ignored: overlap-save computes the
        same convolution).  A stage asked for without a source, or whose
        store yields nothing, is skipped."""
        from wekws_tpu_torch.data import audio
        from wekws_tpu_torch.data.blobstore import open_store
        from wekws_tpu_torch.data.processor import snr_range_for_key

        dev = resolve_device(device)

        def _resolve(p):
            return p if os.path.isabs(p) else os.path.join(data_dir, p)

        logging.info("device augmentation computes in float32 (TF32 off); "
                     "device_aug_dtype %s and device_aug_precision %s are "
                     "not used (ROADMAP C.15)",
                     conf.get("device_aug_dtype", "bfloat16"),
                     conf.get("device_aug_precision", "default"))
        if conf.get("reverb_block_dft", False):
            logging.info("reverb_block_dft is ignored: reverb runs one "
                         "full-utterance DFT, the same linear convolution "
                         "as overlap-save (ROADMAP C.15)")
        speeds = SPEEDS
        out_len = int(np.ceil(max_wave_samples / min(speeds))) \
            if conf.get("speed_perturb", False) else max_wave_samples

        fft = rir_re = rir_im = None
        if conf.get("reverb_prob", 0) > 0 and conf.get("reverb_source"):
            store = open_store(_resolve(conf["reverb_source"]), seed=0)
            rirs = []
            for i in range(len(store)):
                _, blob = store.get(i)
                rir, _ = audio.read_wav(blob)
                norm = float(np.sqrt(np.sum(rir.astype(np.float64) ** 2)))
                if norm > 0:
                    rirs.append(rir / norm)
            if rirs:
                fft = MatmulFFT.for_length(
                    out_len + max(len(r) for r in rirs) - 1, device=dev)
                spec = np.zeros((len(rirs), fft.nh), np.complex64)
                for i, r in enumerate(rirs):
                    spec[i] = fft.spectrum_mat_half(
                        np.asarray(r)).reshape(-1)
                rir_re = torch.from_numpy(
                    np.ascontiguousarray(spec.real)).to(dev)
                rir_im = torch.from_numpy(
                    np.ascontiguousarray(spec.imag)).to(dev)

        noise_rows = snr_lo = snr_hi = None
        if conf.get("noise_prob", 0) > 0 and conf.get("noise_source"):
            store = open_store(_resolve(conf["noise_source"]), seed=0)
            rows, los, his = [], [], []
            for i in range(len(store)):
                key, blob = store.get(i)
                w, _ = audio.read_wav(blob)
                if not len(w):
                    continue
                lo, hi = snr_range_for_key(key)
                for v in range(crop_variants):
                    off = (v * len(w)) // crop_variants
                    rows.append(np.resize(
                        np.roll(w, -off), (out_len,)) * wave_scale)
                    los.append(lo)
                    his.append(hi)
            if rows:
                noise_rows = torch.from_numpy(
                    np.stack(rows).astype(np.float32)).to(dev)
                snr_lo = torch.tensor(los, dtype=torch.float32, device=dev)
                snr_hi = torch.tensor(his, dtype=torch.float32, device=dev)

        aug = cls(
            speed_perturb=bool(conf.get("speed_perturb", False)),
            speeds=speeds, fft=fft, rir_re=rir_re, rir_im=rir_im,
            reverb_prob=float(conf.get("reverb_prob", 0.0)),
            noise_rows=noise_rows, snr_lo=snr_lo, snr_hi=snr_hi,
            noise_prob=float(conf.get("noise_prob", 0.0)),
            power_scale=1.0 / wave_scale)
        return aug.to(dev)
