"""Device-batched streaming feature frontend for multi-stream serving.

Port of wekws_tpu/runtime/device_frontend.py.  The host
``StreamingFrontend`` computes features + splice + frame skip in numpy,
per stream, per chunk.  Here the whole feature chain runs in the SAME
step function as the model: the host keeps only a per-stream raw-sample
buffer and three integers of bookkeeping, and every step featurizes all
streams in one batched call.

Exact-equivalence contract with ``StreamingFrontend`` (the reference
bookkeeping):

* raw frames are snip_edges, shift-aligned from absolute sample 0;
* spliced frame ``j`` concatenates raw frames ``j-L .. j+R`` with the
  replicate-pad-at-0 rule for the stream head, and exists only once
  raw ``j+R`` is computable;
* frame skip keeps spliced frames with absolute index = 0 (mod K).

Geometry: a step emits M spliced+skipped frames with absolute spliced
indices ``next, next+K, ..., next+(M-1)K``.  The wave window starts at
raw frame ``next-L`` (samples before 0 zero-filled) and spans a FIXED
``n_raw = L + (M-1)K + R + 1`` raw frames, so the local centre of
output m is always ``L + mK``; the replicate-pad rule falls out of
clamping the gather index at ``lo = max(0, L - next)`` (the local index
of absolute raw frame 0).  No gathered frame overlaps the zero-filled
samples before the stream head.

The raw frames come from ``FeatureExtractor(cfg, use_fused=True)``:
on the card ``fused_fbank`` (ops/fused_frontend.py, the hand kernel of
the JAX package's ``fused_frontend`` Pallas kernel), fbank or MFCC as
the configuration says; on the CPU its plain three-matmul version.
The JAX featurizer runs XLA's matmul chain instead: the port puts this
function on its kernel, as ROADMAP C.11 records.  Dither is forced to 0.
"""

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from wekws_tpu_torch.device import resolve_device
from wekws_tpu_torch.frontend.features import FeatureExtractor
from wekws_tpu_torch.frontend.kaldi import FrontendConfig


class WaveStreamBuffer:
    """Per-stream host bookkeeping for the device featurizer: a raw
    sample buffer plus the absolute spliced-frame cursor."""

    def __init__(self, shift: int, wlen: int, left: int, right: int,
                 skip: int, step_frames: int):
        self.shift = shift
        self.wlen = wlen
        self.left = left
        self.right = right
        self.skip = max(skip, 1)
        self.m = step_frames
        self.n_raw = left + (step_frames - 1) * self.skip + right + 1
        self.window_samples = (self.n_raw - 1) * shift + wlen
        self.reset()

    def reset(self) -> None:
        self._chunks: List[np.ndarray] = []
        self._buflen = 0
        self._abs_start = 0      # absolute sample index of buffer[0]
        self._next = 0           # absolute spliced index of next output
        self._flat: np.ndarray = np.zeros((0,), np.float32)

    def append(self, samples: np.ndarray) -> None:
        if samples.size:
            self._chunks.append(np.asarray(samples, np.float32))
            self._buflen += samples.size

    def available_outputs(self) -> int:
        """Spliced+skipped frames emittable with full right context."""
        end = self._abs_start + self._buflen
        last_raw = (end - self.wlen) // self.shift
        if last_raw < 0:
            return 0
        return max((last_raw - self.right - self._next) // self.skip + 1, 0)

    @property
    def next_index(self) -> int:
        """Absolute spliced index of the next output."""
        return self._next

    def _flatten(self) -> np.ndarray:
        if self._chunks:
            self._flat = np.concatenate([self._flat] + self._chunks)
            self._chunks = []
        return self._flat

    def window(self) -> Tuple[np.ndarray, int]:
        """Fixed-shape wave window + the gather clamp ``lo``.

        Zero-fills samples before absolute 0 (stream head) and past the
        buffered end (flush tails: those raw frames only feed outputs
        beyond the valid count, which the engine masks downstream)."""
        buf = self._flatten()
        a0 = self._next - self.left
        start = a0 * self.shift
        out = np.zeros((self.window_samples,), np.float32)
        src = start - self._abs_start
        s0, s1 = max(src, 0), min(src + self.window_samples, self._buflen)
        if s1 > s0:
            out[s0 - src:s1 - src] = buf[s0:s1]
        return out, max(0, -a0)

    def consume(self, m: int) -> np.ndarray:
        """Advance by ``m`` outputs; returns their absolute spliced
        indices (the ``_pending_idx`` contract of the host path)."""
        idx = (self._next + np.arange(m) * self.skip).astype(np.int64)
        self._next += m * self.skip
        keep_from = max(self._next - self.left, 0) * self.shift
        drop = keep_from - self._abs_start
        if drop > 0:
            buf = self._flatten()
            self._flat = buf[min(drop, self._buflen):]
            self._buflen = self._flat.size
            self._abs_start = keep_from if drop <= len(buf) else \
                self._abs_start + len(buf)
        return idx


def build_batch_featurizer(cfg: FrontendConfig, left: int, right: int,
                           skip: int, step_frames: int, device="cuda"):
    """Returns ``(featurize, window_samples)`` with ``featurize`` a
    function ``(waves (N, W) float32, lo (N,) int) -> (N, M,
    D*(L+1+R))`` running batched features + splice + skip on ``device``
    (CUDA unless the caller asks for the CPU).  Host arrays are copied
    there; the result stays there."""
    device = resolve_device(device)
    cfg = dataclasses.replace(cfg, dither=0.0)
    fe = FeatureExtractor(cfg, use_fused=True)
    skip = max(skip, 1)
    n_raw = left + (step_frames - 1) * skip + right + 1
    window_samples = (n_raw - 1) * cfg.frame_shift + cfg.frame_length
    # local centres, fixed: output m sits at raw frame left + m * skip
    centers = torch.arange(step_frames, device=device) * skip + left
    offsets = [centers + d for d in range(-left, right + 1)]

    def featurize(waves, lo):
        waves = torch.as_tensor(waves, dtype=torch.float32, device=device)
        lo_col = torch.as_tensor(lo, device=device).to(torch.int64)
        lo_col = lo_col.reshape(-1, 1)
        raw, _ = fe(waves)                       # (N, n_raw, D)
        dim = raw.shape[-1]
        parts = []
        for off in offsets:
            idx = torch.maximum(off[None, :], lo_col).clamp(max=n_raw - 1)
            parts.append(torch.gather(
                raw, 1, idx[..., None].expand(-1, -1, dim)))
        return torch.cat(parts, dim=-1)          # (N, M, D*(L+1+R))

    return featurize, window_samples
