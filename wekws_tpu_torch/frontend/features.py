"""Batched Kaldi-compatible feature extraction on the device.

Port of wekws_tpu/frontend/features.py.  The training pipeline ships
raw padded waveforms (int16 scale) and computes features on the card:
framing, then DC removal, preemphasis, window and the real DFT folded
into ONE ``(frame_length, 2 * (nfft/2 + 1))`` analysis matrix
(precomputed in float64), power, a mel matmul, the log floor and, for
MFCC, a DCT with the cepstral lifter.

All products run in float32.  The JAX package's ``precision`` knob
('high' = bf16_3x, 'default' = one bf16 pass on the TPU's matrix unit)
has no counterpart here: both settings give full float32 products, as
long as the caller leaves ``torch.backends.cuda.matmul.allow_tf32`` at
its default (False); this module never changes that flag.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from wekws_tpu_torch.frontend.kaldi import (
    EPSILON,
    FrontendConfig,
    dct_matrix,
    lifter_coeffs,
    mel_banks,
)


def _dft_matrix(frame_length: int, padded_size: int) -> np.ndarray:
    """Real-input DFT as a matmul: (frame_length, 2 * (padded/2 + 1)),
    columns [cos | -sin] of the one-sided spectrum.  Only the first
    ``frame_length`` rows of the padded frame are nonzero, so the
    matrix contracts the un-padded frame directly."""
    n = np.arange(frame_length, dtype=np.float64)[:, None]
    k = np.arange(padded_size // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / padded_size
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)


def frame_waveform(waves: torch.Tensor, frame_length: int,
                   frame_shift: int) -> torch.Tensor:
    """(B, S) -> (B, T, frame_length) with snip_edges framing."""
    b, s = waves.shape
    if s < frame_length:
        return waves.new_zeros((b, 0, frame_length))
    return waves.unfold(1, frame_length, frame_shift)


class FeatureExtractor:
    """Batched fbank/MFCC with Kaldi semantics.

    ``feats, feat_lengths = fe(waves, wave_lengths, generator)``:
    ``waves`` is (B, S) in int16 scale on any device; the result lies
    on the same device.  Frames past ``feat_lengths`` hold garbage and
    are masked downstream.  Dither draws its noise from ``generator``
    (a ``torch.Generator`` on the waves' device); without one there is
    no dither."""

    def __init__(self, cfg: FrontendConfig, use_fused: bool = False):
        if cfg.feature_type not in ("fbank", "mfcc"):
            raise ValueError(f"unknown feature_type {cfg.feature_type}")
        if not cfg.snip_edges:
            raise NotImplementedError("only snip_edges=True is supported")
        if use_fused:
            raise NotImplementedError(
                "the fused fbank kernel (wekws_tpu/ops/fused_frontend.py) "
                "is not ported yet (ROADMAP queue B, row 3)"
            )
        if cfg.dither_mode not in ("frame", "wave"):
            raise ValueError(f"unknown dither_mode {cfg.dither_mode}")
        self.cfg = cfg
        n = cfg.padded_window_size
        length = cfg.frame_length
        # DC removal (I - J/L), preemphasis (bidiagonal, Kaldi's
        # x0 -= coeff * x0) and the window are linear in the frame:
        # fold them and the DFT into one float64 matrix
        analysis = _dft_matrix(length, n)
        analysis = np.asarray(cfg.window(), np.float64)[:, None] * analysis
        if cfg.preemphasis != 0.0:
            p = np.eye(length)
            p[0, 0] = 1.0 - cfg.preemphasis
            p[np.arange(0, length - 1), np.arange(1, length)] = \
                -cfg.preemphasis
            analysis = p @ analysis
        if cfg.remove_dc_offset:
            analysis = analysis - np.mean(analysis, axis=0, keepdims=True)
        bank = mel_banks(cfg.num_mel_bins, n, cfg.sample_rate, cfg.low_freq,
                         cfg.high_freq)
        mats = {"analysis": analysis, "mel_t": bank.T}
        if cfg.feature_type == "mfcc":
            dct = dct_matrix(cfg.num_ceps, cfg.num_mel_bins)
            if cfg.cepstral_lifter != 0.0:
                dct = dct * lifter_coeffs(cfg.num_ceps,
                                          cfg.cepstral_lifter)[None, :]
            mats["dct"] = dct
        self._cpu = {k: torch.tensor(np.asarray(v, np.float32))
                     for k, v in mats.items()}
        self._on_device = {}

    @property
    def feat_dim(self) -> int:
        return self.cfg.feat_dim

    def _mats(self, device: torch.device):
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = {k: v.to(device)
                                    for k, v in self._cpu.items()}
        return self._on_device[key]

    def num_frames(self, num_samples: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n = 1 + torch.div(num_samples - cfg.frame_length, cfg.frame_shift,
                          rounding_mode="floor")
        return torch.where(num_samples >= cfg.frame_length, n,
                           torch.zeros_like(n))

    def __call__(
        self,
        waves: torch.Tensor,
        lengths: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        waves = waves.to(torch.float32)
        dither = cfg.dither != 0.0 and generator is not None
        if dither and cfg.dither_mode == "wave":
            waves = waves + cfg.dither * torch.randn(
                waves.shape, generator=generator, device=waves.device)
        mats = self._mats(waves.device)
        frames = frame_waveform(waves, cfg.frame_length, cfg.frame_shift)
        if dither and cfg.dither_mode == "frame":
            frames = frames + cfg.dither * torch.randn(
                frames.shape, generator=generator, device=waves.device)
        spec = torch.matmul(frames, mats["analysis"])
        nbin = mats["analysis"].shape[1] // 2
        power = spec[..., :nbin] ** 2 + spec[..., nbin:] ** 2
        if not cfg.use_power:
            power = torch.sqrt(power)
        mel = torch.matmul(power, mats["mel_t"])
        if cfg.use_log_fbank:
            mel = torch.log(torch.clamp(mel, min=EPSILON))
        if "dct" in mats:
            mel = torch.matmul(mel, mats["dct"])
        feat_lengths = None if lengths is None else self.num_frames(lengths)
        return mel, feat_lengths


def frontend_config_from_dataset_conf(conf: dict) -> FrontendConfig:
    """Supports both config schemas of the reference: the legacy
    ``feature_extraction_conf`` (with ``feature_type``) and the
    ``feats_type`` + ``fbank_conf``/``mfcc_conf`` layout."""
    if "feature_extraction_conf" in conf:
        fc = conf["feature_extraction_conf"]
        ftype = fc.get("feature_type", "fbank")
    else:
        ftype = conf.get("feats_type", "fbank")
        fc = conf.get(f"{ftype}_conf", {})
    resample = conf.get("resample_conf", {}).get("resample_rate", 16000)
    return FrontendConfig(
        feature_type=ftype,
        sample_rate=resample,
        num_mel_bins=fc.get("num_mel_bins", 40),
        num_ceps=fc.get("num_ceps", fc.get("num_mel_bins", 40)),
        frame_length_ms=fc.get("frame_length", 25),
        frame_shift_ms=fc.get("frame_shift", 10),
        dither=fc.get("dither", 0.0),
        dither_mode=fc.get("dither_mode", "frame"),
        precision=fc.get("precision", "high"),
    )


def frontend_from_dataset_conf(conf: dict,
                               use_fused: bool = False) -> FeatureExtractor:
    """A ``FeatureExtractor`` from a wekws-style ``dataset_conf``; its
    ``FrontendConfig`` is ``.cfg``."""
    return FeatureExtractor(frontend_config_from_dataset_conf(conf),
                            use_fused=use_fused)
