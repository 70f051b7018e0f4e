"""Kaldi log-mel filterbank and MFCC, and the per-step draws.

Kaldi's definition (``snip_edges`` framing, per-frame DC removal,
preemphasis 0.97 with ``x0 -= 0.97 x0``, the povey window, a power
spectrum of the frame zero-padded to a power of two, triangular mel
filters from 20 Hz to Nyquist on Kaldi's mel scale, a natural log with
float32's epsilon as its floor, and for MFCC Kaldi's normalised DCT-II
and the cepstral lifter), written with ``torch.fft.rfft``.

The dither follows the frozen rule of the training step: a generator
on the waves' device seeded with ``(seed * 1000003 + step) % 2**63``
draws one int64 seed from ``randint(0, 2**62)`` (Kaldi's frame-mode
dither; no other mode is written here).  The dither on a CUDA device is Philox4x32-10 keyed by that seed, its counter the index of
the (row, sample) quad of the flattened (utterance, frame) rows,
Box-Muller on 24-bit uniforms; on the CPU it is ``randn`` of the frames'
shape from a generator seeded with it.
"""

import math
from typing import Optional

import torch

EPSILON = 1.1920928955078125e-07  # float32 machine epsilon
M32 = 0xFFFFFFFF


def step_generator(seed: int, step: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + int(step)) % (2 ** 63))
    return gen


def _mel(freq):
    return 1127.0 * torch.log1p(freq / 700.0)


def mel_bank(num_bins: int, n_fft: int, sample_rate: float,
             low: float = 20.0, high: float = 0.0,
             device=None) -> torch.Tensor:
    """(n_fft // 2 + 1, num_bins) float64: Kaldi's triangular filters,
    the Nyquist bin's row zero."""
    nyquist = 0.5 * sample_rate
    high = nyquist + high if high <= 0 else high
    mel_low, mel_high = _mel(torch.tensor(low, dtype=torch.float64)), \
        _mel(torch.tensor(high, dtype=torch.float64))
    delta = (mel_high - mel_low) / (num_bins + 1)
    left = mel_low + delta * torch.arange(num_bins, dtype=torch.float64)
    centre, right = left + delta, left + 2 * delta
    freqs = sample_rate / n_fft * torch.arange(n_fft // 2,
                                               dtype=torch.float64)
    mel = _mel(freqs)[:, None]
    up = (mel - left[None]) / (centre - left)[None]
    down = (right[None] - mel) / (right - centre)[None]
    bank = torch.clamp(torch.minimum(up, down), min=0.0)
    bank = torch.cat([bank, bank.new_zeros((1, num_bins))])
    return bank.to(device)


def dct_lifter(num_ceps: int, num_mel: int, lifter: float = 22.0,
               device=None) -> torch.Tensor:
    """(num_mel, num_ceps) float64: Kaldi's normalised DCT-II, each
    column times its cepstral lifter coefficient."""
    m = torch.arange(num_mel, dtype=torch.float64)[:, None]
    k = torch.arange(num_ceps, dtype=torch.float64)[None, :]
    dct = math.sqrt(2.0 / num_mel) * torch.cos(math.pi / num_mel
                                               * (m + 0.5) * k)
    dct[:, 0] = math.sqrt(1.0 / num_mel)
    if lifter:
        i = torch.arange(num_ceps, dtype=torch.float64)
        dct = dct * (1.0 + 0.5 * lifter * torch.sin(math.pi * i / lifter))
    return dct.to(device)


class Features:
    """Kaldi fbank (``num_ceps`` None) or MFCC of int16-scaled waves."""

    def __init__(self, conf: dict, device):
        ftype = conf.get("feats_type", "fbank")
        fc = conf.get(f"{ftype}_conf", {})
        self.mfcc = ftype == "mfcc"
        self.sample_rate = conf.get("resample_conf", {}).get(
            "resample_rate", 16000)
        self.num_mel = fc.get("num_mel_bins", 40)
        self.num_ceps = fc.get("num_ceps", self.num_mel) if self.mfcc \
            else None
        self.frame_length = int(self.sample_rate
                                * fc.get("frame_length", 25) / 1000)
        self.frame_shift = int(self.sample_rate
                               * fc.get("frame_shift", 10) / 1000)
        self.dither = float(fc.get("dither", 0.0))
        if self.dither and fc.get("dither_mode", "frame") != "frame":
            raise ValueError("only the frame-mode dither")
        self.n_fft = 1 << (self.frame_length - 1).bit_length()
        n = torch.arange(self.frame_length, dtype=torch.float64)
        hann = 0.5 - 0.5 * torch.cos(2 * math.pi * n
                                     / (self.frame_length - 1))
        self.window = (hann ** 0.85).to(torch.float32).to(device)
        self.bank = mel_bank(self.num_mel, self.n_fft, self.sample_rate,
                             device=device).to(torch.float32)
        self.dct = None if not self.mfcc else dct_lifter(
            self.num_ceps, self.num_mel, device=device).to(torch.float32)

    @property
    def dim(self) -> int:
        return self.num_ceps if self.mfcc else self.num_mel

    def num_frames(self, samples: int) -> int:
        if samples < self.frame_length:
            return 0
        return 1 + (samples - self.frame_length) // self.frame_shift

    def frames(self, waves: torch.Tensor) -> torch.Tensor:
        return waves.unfold(1, self.frame_length, self.frame_shift)

    def from_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, L) float32 frames -> (B, T, D) features."""
        x = frames - frames.mean(dim=-1, keepdim=True)
        x = torch.cat([x[..., :1] * (1 - 0.97),
                       x[..., 1:] - 0.97 * x[..., :-1]], dim=-1)
        x = x * self.window
        spec = torch.fft.rfft(x, n=self.n_fft, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        mel = torch.log(torch.clamp(torch.matmul(power, self.bank),
                                    min=EPSILON))
        if self.dct is not None:
            mel = torch.matmul(mel, self.dct)
        return mel

    def __call__(self, waves: torch.Tensor,
                 gen: Optional[torch.Generator] = None,
                 rows: int = 64) -> torch.Tensor:
        """(B, S) waves -> (B, T, D) features; ``gen`` (a step
        generator) draws the dither, none without it."""
        waves = waves.to(torch.float32)
        frame_seed = None
        if gen is not None and self.dither:
            frame_seed = int(torch.randint(
                0, 2 ** 62, (1,), generator=gen, device=waves.device,
                dtype=torch.int64).item())
        b = waves.shape[0]
        t = self.num_frames(waves.shape[1])
        outs = []
        cpu_noise = None
        if frame_seed is not None and waves.device.type != "cuda":
            g = torch.Generator(device=waves.device).manual_seed(frame_seed)
            cpu_noise = torch.randn((b, t, self.frame_length), generator=g,
                                    device=waves.device)
        for r0 in range(0, b, rows):
            fr = self.frames(waves[r0:r0 + rows])
            if frame_seed is not None:
                if cpu_noise is not None:
                    noise = cpu_noise[r0:r0 + rows]
                else:
                    noise = philox_normal(frame_seed,
                                          r0 * t * self.frame_length,
                                          fr.numel(), waves.device)
                    noise = noise.view(fr.shape)
                fr = fr + self.dither * noise
            outs.append(self.from_frames(fr))
        return torch.cat(outs)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m * x, for uint32
    values held in int64, without overflowing int64."""
    p1 = m * (x & 0xFFFF)
    p2 = m * (x >> 16)
    s = p1 + ((p2 & 0xFFFF) << 16)
    return ((p2 >> 16) + (s >> 32)) & M32, s & M32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counters (uint32 values in int64 tensors)
    under the key (k0, k1)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & M32
        k1 = (k1 + 0xBB67AE85) & M32
    return c0, c1, c2, c3


def philox_normal(seed: int, first: int, count: int,
                  device) -> torch.Tensor:
    """N(0, 1) noise of elements ``first .. first + count`` (``first`` a
    multiple of 4): element e is word ``e % 4`` of Philox at counter
    ``e // 4``, two words to a Box-Muller pair."""
    q0 = first // 4
    nq = (count + 3) // 4
    q = torch.arange(q0, q0 + nq, dtype=torch.int64, device=device)
    zero = torch.zeros_like(q)
    words = philox4x32_10(q & M32, q >> 32, zero, zero,
                          seed & M32, (seed >> 32) & M32)
    out = []
    for a, b in (words[:2], words[2:]):
        u1 = ((a >> 8).to(torch.float64) + 1.0) / 16777216.0
        u2 = (b >> 8).to(torch.float64) / 16777216.0
        r = torch.sqrt(-2.0 * torch.log(u1.to(torch.float32)
                                        .to(torch.float64)))
        ang = 2.0 * math.pi * u2.to(torch.float32).to(torch.float64)
        out += [(r * torch.cos(ang)).to(torch.float32),
                (r * torch.sin(ang)).to(torch.float32)]
    return torch.stack(out, dim=1).reshape(-1)[:count]
