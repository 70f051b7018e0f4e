"""Batched multi-stream max-pooling wake-word engine.

Port of the host-frontend half of wekws_tpu/runtime/batch_spotter.py:
N independent PCM streams served through ONE batched, cached model
step on the device, with per-stream host frontends and detection.

Correctness under batching (unchanged from the JAX engine):

* **Lockstep frames.** Every step runs ``step_frames`` frames per
  stream.  A stream takes part only when it has that many frames
  queued; other rows carry zero features and their cache rows are
  restored from the pre-step cache, so a slow stream's state is
  bit-identical to never having run.  Causality makes the taking-part
  rows exact: frame t depends only on frames <= t and the cache of its
  own row.
* **Stream resets** (slot reuse) zero that row's cache through a reset
  mask applied inside the same step.
* **``flush()`` / ``flush_stream()``** drain sub-``step_frames``
  remainders with ONE zero-padded step of the same shape, masked to
  each row's valid length; flushing finalizes a stream (its cache row
  resets before its next use).

``use_fused=True`` steps the whole-backbone kernel
(ops/serving.py ``build_fused_stream``) with the packed
``(L, B, pad_max, C)`` cache, whose rows are axis 1; otherwise the
module runs with its own cache, rows on axis 0: a tuple of
``(B, (K-1)*d, C)`` caches for MDTC and TCN, the ``(B, layers, H)``
hidden state for a GRU (which has no fused stream; ``use_fused=True``
raises for it).  The device
frontend, device decode and the batched CTC engine are not ported yet;
the single-stream CTC engine is runtime/keyword_spotter.py.
"""

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from wekws_tpu_torch.device import resolve_device
from wekws_tpu_torch.ops.serving import build_fused_stream
from wekws_tpu_torch.runtime.keyword_spotter import (
    load_serving_model,
    load_spotter_config,
)
from wekws_tpu_torch.runtime.streaming_frontend import StreamingFrontend


class _BatchedStreamEngine:
    """Shared multi-stream machinery: per-stream frontends, pending
    feature queues, lockstep step/flush scheduling and reset masks.

    Subclasses implement ``_dispatch(ready, t, feats, active, reset,
    tvalid)`` (one batched device step + per-stream results) and
    ``_reset_host_state(stream)``."""

    def _init_streams(self, num_streams: int, step_frames: int,
                      cache) -> None:
        if num_streams < 1 or step_frames < 1:
            raise ValueError("num_streams and step_frames must be >= 1")
        self.num_streams = num_streams
        self.step_frames = step_frames
        self.frontends = [
            StreamingFrontend(*self._frontend_args)
            for _ in range(num_streams)
        ]
        self._pending_feats: List[np.ndarray] = [
            np.zeros((0, self.feat_dim), np.float32)
            for _ in range(num_streams)
        ]
        self._pending_idx: List[np.ndarray] = [
            np.zeros((0,), np.int64) for _ in range(num_streams)
        ]
        self._reset_mask = np.zeros((num_streams,), bool)
        self.cache = cache
        # overflow events beyond the one-result-per-step contract
        self._event_backlog: List[List[Dict]] = [
            [] for _ in range(num_streams)
        ]
        self.stats = {"dispatches": 0, "rows": 0, "frames": 0,
                      "dispatch_s": 0.0}

    # ------------- streaming -------------

    def accept_wave(self, stream: int, wave: bytes) -> None:
        """Queue a PCM chunk (int16 LE bytes) for one stream."""
        data = np.frombuffer(wave, dtype="<i2").astype(np.float32)
        feats, idx = self.frontends[stream].accept_waveform(data)
        if feats.shape[0]:
            self._pending_feats[stream] = np.concatenate(
                [self._pending_feats[stream], feats]
            )
            self._pending_idx[stream] = np.concatenate(
                [self._pending_idx[stream], idx]
            )

    def pending_frames(self, stream: int) -> int:
        return self._pending_feats[stream].shape[0]

    def step(self) -> Dict[int, Dict]:
        """One batched step over every stream holding at least
        ``step_frames`` queued frames -> {stream: result}."""
        ready = [
            i for i in range(self.num_streams)
            if self.pending_frames(i) >= self.step_frames
        ]
        if not ready:
            return {}
        return self._run(ready, self.step_frames)

    def flush(self) -> Dict[int, Dict]:
        """Drain every stream: full lockstep steps first, then ONE
        zero-padded, length-masked step for all sub-step tails.
        Returns the last result per flushed stream and finalizes the
        flushed slots."""
        results: Dict[int, Dict] = {}
        while True:
            ran = self.step()
            if not ran:
                break
            results.update(ran)
        tails = {
            i: self.pending_frames(i)
            for i in range(self.num_streams)
            if self.pending_frames(i) >= 1
        }
        if tails:
            results.update(
                self._run(sorted(tails), self.step_frames, lengths=tails)
            )
            for i in tails:
                self._reset_mask[i] = True
        for i in range(self.num_streams):
            drained = self._drain_backlog(i)
            if drained:
                results[i] = drained[-1]
        return results

    def flush_stream(self, stream: int) -> List[Dict]:
        """Drain one stream without stepping the others: full steps,
        then one zero-padded, length-masked step for the remainder.
        Returns that stream's results in order."""
        results: List[Dict] = []
        while self.pending_frames(stream) >= self.step_frames:
            results.append(self._run([stream], self.step_frames)[stream])
        rem = self.pending_frames(stream)
        if rem:
            results.append(
                self._run([stream], self.step_frames,
                          lengths={stream: rem})[stream]
            )
            self._reset_mask[stream] = True
        results.extend(self._drain_backlog(stream))
        return results

    def _drain_backlog(self, stream: int) -> List[Dict]:
        out = self._event_backlog[stream]
        self._event_backlog[stream] = []
        return out

    def _run(self, ready: List[int], t: int,
             lengths: Optional[Dict[int, int]] = None) -> Dict[int, Dict]:
        """One batched step over ``ready`` rows at chunk size ``t``;
        ``lengths`` marks rows with fewer than ``t`` valid frames."""
        n, d = self.num_streams, self.feat_dim
        active = np.zeros((n,), bool)
        tvalid: Dict[int, int] = {}
        for i in ready:
            k = t
            if lengths is not None and i in lengths:
                k = min(int(lengths[i]), t)
            active[i] = True
            tvalid[i] = k
        feats = np.zeros((n, t, d), np.float32)
        for i in ready:
            feats[i, :tvalid[i]] = self._pending_feats[i][:tvalid[i]]
        reset = self._reset_mask.copy()
        self._reset_mask[:] = False
        t0 = time.perf_counter()
        out = self._dispatch(ready, t, feats, active, reset, tvalid)
        self.stats["dispatches"] += 1
        self.stats["rows"] += len(ready)
        self.stats["frames"] += sum(tvalid.values())
        self.stats["dispatch_s"] += time.perf_counter() - t0
        return out

    def _consume(self, stream: int, t: int) -> np.ndarray:
        """Advance one stream's queue by ``t`` frames; returns the
        consumed frames' global indices."""
        idx = self._pending_idx[stream][:t]
        self._pending_feats[stream] = self._pending_feats[stream][t:]
        self._pending_idx[stream] = self._pending_idx[stream][t:]
        return idx

    # ------------- state -------------

    def reset_stream(self, stream: int) -> None:
        """Free a slot for a new client: clears frontend, queue, decode
        state and (on the next step) the cache row."""
        self._reset_host_state(stream)
        self.frontends[stream].reset()
        self._pending_feats[stream] = np.zeros((0, self.feat_dim),
                                               np.float32)
        self._pending_idx[stream] = np.zeros((0,), np.int64)
        self._reset_mask[stream] = True

    def reset_all(self) -> None:
        for i in range(self.num_streams):
            self.reset_stream(i)

    def _dispatch(self, ready, t, feats, active, reset, tvalid):
        raise NotImplementedError

    def _reset_host_state(self, stream: int) -> None:
        raise NotImplementedError


def _where_rows(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor,
                axis: int) -> torch.Tensor:
    shape = [1] * old.dim()
    shape[axis] = -1
    return torch.where(mask.view(shape), new, old)


class BatchMaxPoolSpotter(_BatchedStreamEngine):
    """Batched multi-stream serving for max-pooling wake-word models.

    A stream fires keyword k at the first frame whose sigmoid posterior
    reaches ``threshold``, then stays silent for that (stream, keyword)
    for ``interval_frames`` frames (compute_det's window_shift
    suppression).  ``config`` is a resolved train config, as a dict or
    a YAML path; ``ckpt_path`` a port ``.pt`` or a JAX-package ``.ckpt``
    (a float32 model whatever ``model.dtype`` says).  Runs on ``device``,
    CUDA unless the caller asks for the CPU."""

    def __init__(
        self,
        ckpt_path: str,
        config,
        threshold: float,
        num_streams: int = 16,
        step_frames: int = 8,
        interval_frames: int = 50,
        keyword_names: Optional[List[str]] = None,
        use_fused: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        configs, cfg, left, right, downsampling = load_spotter_config(config)
        self.sample_rate = cfg.sample_rate
        # frontend frame indices are global pre-skip indices, so wall
        # time is idx * frame_shift
        self.resolution = cfg.frame_shift_ms / 1000.0
        self._frontend_args = (cfg, left, right, downsampling)
        self.feat_dim = cfg.feat_dim * (left + 1 + right)
        self.model = load_serving_model(configs, ckpt_path, self.feat_dim,
                                        self.device)
        num_keywords = int(configs["model"]["output_dim"])
        self.keyword_names = keyword_names or [
            str(k) for k in range(num_keywords)
        ]
        if len(self.keyword_names) != num_keywords:
            raise ValueError("keyword_names must name every output")

        if use_fused:
            fused = build_fused_stream(self.model, device=self.device)
            if fused is None:
                raise ValueError(
                    "use_fused=True: this model is not supported by the "
                    "fused stream (needs a DS-TCN or MDTC with linear "
                    "preprocessing or an FSMN, and a linear, element or "
                    "identity head)"
                )
            apply, init_cache = fused
            cache, row_axis = init_cache(num_streams), 1
        else:
            apply = self.model
            cache, row_axis = self.model.init_cache(num_streams,
                                                    self.device), 0
        dev = self.device
        zero = torch.zeros((), device=dev)

        def step_fn(feats, active, reset, cache):
            with torch.inference_mode():
                feats = torch.as_tensor(feats, device=dev)
                active = torch.as_tensor(active, device=dev)
                reset = torch.as_tensor(reset, device=dev)

                def masked(fn, *trees):
                    if isinstance(trees[0], torch.Tensor):
                        return fn(*trees)
                    return tuple(fn(*leaves) for leaves in zip(*trees))

                cache = masked(
                    lambda c: _where_rows(reset, zero, c, row_axis), cache)
                probs, new_cache = apply(feats, cache)
                out_cache = masked(
                    lambda n, o: _where_rows(active, n, o, row_axis),
                    new_cache, cache)
                return probs, out_cache

        self._step_fn = step_fn
        self.threshold = float(threshold)
        self.interval_frames = int(interval_frames)
        self._last_fire = np.full(
            (num_streams, num_keywords), -(10**9), np.int64
        )
        self._init_streams(num_streams, step_frames, cache)

    def _dispatch(self, ready, t, feats, active, reset,
                  tvalid) -> Dict[int, Dict]:
        probs, self.cache = self._step_fn(feats, active, reset, self.cache)
        if isinstance(probs, torch.Tensor):
            probs = probs.cpu().numpy()
        probs = np.asarray(probs)  # (N, T, K)

        results: Dict[int, Dict] = {}
        for i in ready:
            k = tvalid[i]
            idx = self._consume(i, k)
            # one result per stream per step; extra same-chunk fires
            # queue and surface on later steps or at flush
            bl = self._event_backlog[i]
            bl.extend(self._detect_events(i, idx, probs[i][:k]))
            results[i] = bl.pop(0) if bl else dict(self._NO_FIRE)
        return results

    _NO_FIRE = {
        "state": 0, "keyword": None, "frame": None,
        "time": None, "score": None,
    }

    def _detect_events(self, stream: int, idx: np.ndarray,
                       probs: np.ndarray) -> List[Dict]:
        """All threshold crossings in the chunk, refractory applied in
        frame order."""
        hit = probs >= self.threshold  # (T, K)
        fires: List[Dict] = []
        for row, frame in enumerate(idx):
            open_k = np.flatnonzero(
                hit[row]
                & (frame - self._last_fire[stream] > self.interval_frames)
            )
            if open_k.size == 0:
                continue
            k = int(open_k[np.argmax(probs[row, open_k])])
            self._last_fire[stream, k] = frame
            fires.append({
                "state": 1,
                "keyword": self.keyword_names[k],
                "frame": int(frame),
                "time": float(frame) * self.resolution,
                "score": float(probs[row, k]),
            })
        return fires

    def _reset_host_state(self, stream: int) -> None:
        self._last_fire[stream, :] = -(10**9)
        self._event_backlog[stream] = []
