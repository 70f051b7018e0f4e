"""Stateful streaming feature frontend (numpy copy of
wekws_tpu/runtime/streaming_frontend.py).

Chunk-incremental equivalent of the offline pipeline (fbank ->
context_expansion -> frame_skip), with the reference wekws
bookkeeping (bin/stream_kws_ctc.py):

* ``wave_remained``: samples not yet covered by a full frame carry over
  to the next chunk (frames are snip_edges, shift-aligned);
* streaming splice keeps the last ``left+right`` raw feature frames;
  the first chunk replicate-pads the left margin with frame 0;
* frame skip keeps global stride alignment across chunks by tracking
  the absolute spliced-frame index.

Emits (features, absolute_frame_indices) per chunk; concatenated over
chunks the output equals the offline pipeline on the whole waveform
(tests/test_torch_frontend.py).

The feature is the configured one: MFCC when ``cfg.feature_type`` is
``mfcc``, else log-mel fbank.  This departs from the JAX package's copy,
which computes fbank whatever the configuration says; the port's copy
agrees with its offline pipeline and with the device featurizer
(runtime/device_frontend.py) for an MFCC model (ROADMAP C.10).
"""

from typing import Optional, Tuple

import numpy as np

from wekws_tpu_torch.frontend.kaldi import (
    FrontendConfig,
    compute_fbank_np,
    compute_mfcc_np,
)


class StreamingFrontend:
    def __init__(
        self,
        cfg: FrontendConfig,
        left_context: int = 0,
        right_context: int = 0,
        frame_skip: int = 1,
    ):
        assert cfg.dither == 0.0, "streaming inference must not dither"
        self.cfg = cfg
        self.left = left_context
        self.right = right_context
        self.skip = max(frame_skip, 1)
        self._features = (compute_mfcc_np if cfg.feature_type == "mfcc"
                          else compute_fbank_np)
        self.reset()

    def reset(self) -> None:
        self.wave_remained = np.zeros((0,), np.float32)
        self.feature_remained: Optional[np.ndarray] = None
        self._spliced_count = 0  # absolute index of next spliced frame

    def accept_waveform(
        self, wave: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """int16-scaled float waveform chunk -> (feats, frame_indices).

        feats: (N, D * (left+1+right)); frame_indices: absolute
        pre-skip spliced frame index of each output frame."""
        cfg = self.cfg
        wave = np.concatenate([self.wave_remained, np.asarray(wave, np.float32)])
        if len(wave) < cfg.frame_length:
            self.wave_remained = wave
            return self._empty()
        feats = self._features(wave, cfg)
        n = feats.shape[0]
        self.wave_remained = wave[n * cfg.frame_shift :]
        if n == 0:
            return self._empty()

        if self.left or self.right:
            if self.feature_remained is None:
                pad = np.repeat(feats[:1], self.left, axis=0)
                feats_pad = np.concatenate([pad, feats], axis=0)
            else:
                feats_pad = np.concatenate([self.feature_remained, feats], axis=0)
            total = feats_pad.shape[0]
            ctx_win = self.left + self.right + 1
            n_out = total - self.left - self.right
            if n_out <= 0:
                self.feature_remained = feats_pad
                return self._empty()
            out = np.concatenate(
                [feats_pad[i : i + n_out] for i in range(ctx_win)], axis=1
            )
            self.feature_remained = feats_pad[-(self.left + self.right) :]
            feats = out

        idx = self._spliced_count + np.arange(feats.shape[0])
        self._spliced_count += feats.shape[0]
        if self.skip > 1:
            keep = (idx % self.skip) == 0
            feats = feats[keep]
            idx = idx[keep]
        return feats.astype(np.float32), idx.astype(np.int64)

    def _empty(self):
        dim = self.cfg.feat_dim * (self.left + 1 + self.right)
        return np.zeros((0, dim), np.float32), np.zeros((0,), np.int64)
