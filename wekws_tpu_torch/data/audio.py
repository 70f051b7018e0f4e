"""Host-side audio I/O and waveform transforms (numpy).

Copy of wekws_tpu/data/audio.py: the reference wekws's torchaudio/sox
stages (wekws/dataset/processor.py) in numpy/scipy: WAV read via
scipy.io.wavfile, resampling via polyphase filtering, and sox-style
speed perturbation expressed as resampling.  scipy is imported where
it is used: ``scipy.signal`` takes seconds to import, and every loader
worker and training process imports this module.
"""

import io
from fractions import Fraction
from typing import Tuple, Union

import numpy as np


def read_wav(source: Union[str, bytes]) -> Tuple[np.ndarray, int]:
    """Read a WAV file (path or raw bytes) -> (float32 [-1, 1] mono, sr)."""
    from scipy.io import wavfile

    if isinstance(source, (bytes, bytearray)):
        sr, data = wavfile.read(io.BytesIO(bytes(source)))
    else:
        sr, data = wavfile.read(source)
    if data.ndim > 1:
        data = data[:, 0]
    if data.dtype == np.int16:
        wave = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wave = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wave = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wave = data.astype(np.float32)
    return wave, int(sr)


def write_wav(path: str, wave: np.ndarray, sample_rate: int) -> None:
    """float32 [-1, 1] -> 16-bit PCM WAV."""
    from scipy.io import wavfile

    pcm = np.clip(wave, -1.0, 1.0)
    wavfile.write(path, sample_rate, (pcm * 32767.0).astype(np.int16))


def resample(wave: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (anti-aliased), like torchaudio Resample."""
    if orig_sr == target_sr:
        return wave
    from scipy.signal import resample_poly

    frac = Fraction(target_sr, orig_sr)
    return resample_poly(wave, frac.numerator, frac.denominator).astype(
        np.float32
    )


def speed_perturb(
    wave: np.ndarray, speed: float, method: str = "linear"
) -> np.ndarray:
    """sox 'speed' effect: resample playback — pitch and tempo change
    together; output length == len(wave) / speed.

    ``linear`` (default) interpolates — augmentation-grade quality,
    cheaper than polyphase filtering; ``poly`` uses the anti-aliased
    polyphase path."""
    if speed == 1.0:
        return wave
    if method == "linear":
        # exact rational length: floor(len * q / p) for speed = p/q.
        # int(len / speed) in f64 differs by 1 on exact multiples for
        # speeds like 1.1 (f64 rounding artifact); the rational form is
        # float-free and matches the JAX package's device polyphase
        # path (wekws_tpu/data/device_aug.py) exactly.
        frac = Fraction(speed).limit_denominator(100)
        n_out = len(wave) * frac.denominator // frac.numerator
        pos = np.arange(n_out, dtype=np.float64) * speed
        return np.interp(pos, np.arange(len(wave)), wave).astype(np.float32)
    from scipy.signal import resample_poly

    frac = Fraction(speed).limit_denominator(100)
    return resample_poly(wave, frac.denominator, frac.numerator).astype(
        np.float32
    )
