"""Batched multi-stream keyword spotting engines.

Port of wekws_tpu/runtime/batch_spotter.py: N independent PCM streams
served through ONE batched, cached model step on the device, with
per-stream host state (frontend or raw-sample buffer, beam, FSM) around
it.  ``BatchKeywordSpotter`` serves CTC models, ``BatchMaxPoolSpotter``
max-pooling wake-word models.

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

Detection activation resets only the beam; the model cache carries
across an activation, as in the single-stream engine.

``use_fused=True`` steps the whole-backbone kernel
(ops/serving.py ``build_fused_stream``) with the packed
``(L, B, pad_max, C)`` cache, whose rows are axis 1; otherwise the
module runs with its own cache, rows on axis 0: a tuple of per-layer
``(B, pad, C)`` caches for MDTC, TCN and FSMN, the ``(B, layers, H)``
hidden state for a GRU (which has no fused stream; ``use_fused=True``
raises for it, as for any model the builder does not cover).
``use_fused=None`` takes the route ``ops.serving.forward_route`` gives
the loaded model: the kernel on the card for MDTC, DS-TCN and FSMN, the
modules for GRU and full-conv TCN and on the CPU.  An exported artifact
directory (float or static int8) serves through its
``ArtifactModelAdapter``, rows on axis 0 as the modules' (no fused
kernel: ``use_fused=True`` raises).

``device_frontend=True`` keeps only a raw-sample buffer per stream on
the host (runtime/device_frontend.py) and featurizes every stream in
the step function, before the model: ``fused_fbank`` on the card.

Two decode modes for ``BatchKeywordSpotter``:

* host (default): one ``StreamDetector`` (Python beam + FSM) per slot;
* ``device_decode=True``: the beam + detection FSM run on the device
  in the same step function as the model (decode/device_stream.py),
  and the host reads one packed ``(5, N)`` event tensor a step.

A list of devices as ``device`` (the counterpart of the JAX engines'
``mesh``) splits the streams in equal row blocks over them: each device holds a
copy of the weights, its rows' caches (and decode state) and its own
route (the fused kernel, the artifact runtime or the modules), and a
step enqueues every device's work before it reads any result.  A row's
results do not depend on the batch (causality, per-row caches), so
each stream's posteriors and events are the one-device engine's.
``num_streams`` must divide evenly, as JAX asserts.  JAX's
``decode_unroll`` (a ``lax.scan`` unroll) has no counterpart.
"""

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from wekws_tpu_torch.decode.device_stream import (
    init_stream_state,
    make_keyword_arrays,
    stream_detect_step,
)
from wekws_tpu_torch.device import resolve_device
from wekws_tpu_torch.ops.serving import build_fused_stream, forward_route
from wekws_tpu_torch.runtime.device_frontend import (
    WaveStreamBuffer,
    build_batch_featurizer,
)
from wekws_tpu_torch.runtime.keyword_spotter import (
    StreamDetector,
    build_keyword_tables,
    load_serving_model,
    load_spotter_config,
    use_fused_stream,
)
from wekws_tpu_torch.runtime.streaming_frontend import StreamingFrontend
from wekws_tpu_torch.text.tokenizer import read_lexicon, read_token


def _where_rows(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor,
                axis: int) -> torch.Tensor:
    shape = [1] * old.dim()
    shape[axis] = -1
    return torch.where(mask.view(shape), new, old)


def _split_rows(step_fns, rows: int):
    """One step function over several devices' step functions, device j
    taking rows ``[j rows, (j + 1) rows)``: every device's step is
    enqueued before the caller reads any result.  The cache is a tuple
    of the devices' caches, the posteriors a list of their blocks."""
    def step_fn(feats, active, reset, cache):
        x, lo = feats
        outs = [fn((x[a:a + rows], lo[a:a + rows]), active[a:a + rows],
                   reset[a:a + rows], c)
                for fn, a, c in zip(step_fns, range(0, len(x), rows), cache)]
        return [p for p, _ in outs], tuple(c for _, c in outs)
    return step_fn


def _host_rows(probs) -> np.ndarray:
    """The posteriors of every row on the host: one tensor, or the row
    blocks of several devices in order."""
    if isinstance(probs, torch.Tensor):
        return probs.cpu().numpy()
    return np.concatenate([p.cpu().numpy() for p in probs])


class _FeatureQueue:
    """A stream's source on the host frontend: its ``StreamingFrontend``
    and the queue of spliced frames it has emitted, behind
    ``WaveStreamBuffer``'s interface.  ``window()`` gives the next
    ``step_frames`` frames, zero-padded past the queue's end, and a
    ``lo`` of 0."""

    def __init__(self, frontend_args, feat_dim: int, step_frames: int):
        self.frontend = StreamingFrontend(*frontend_args)
        self.step_frames = step_frames
        self.window_shape = (step_frames, feat_dim)
        self.reset()

    def reset(self) -> None:
        self.frontend.reset()
        self._feats = np.zeros((0, self.window_shape[1]), np.float32)
        self._idx = np.zeros((0,), np.int64)

    def append(self, samples: np.ndarray) -> None:
        feats, idx = self.frontend.accept_waveform(samples)
        if feats.shape[0]:
            self._feats = np.concatenate([self._feats, feats])
            self._idx = np.concatenate([self._idx, idx])

    def available_outputs(self) -> int:
        return self._feats.shape[0]

    @property
    def next_index(self) -> int:
        return int(self._idx[0])

    def window(self):
        out = np.zeros(self.window_shape, np.float32)
        k = min(self._feats.shape[0], self.step_frames)
        out[:k] = self._feats[:k]
        return out, 0

    def consume(self, m: int) -> np.ndarray:
        idx = self._idx[:m]
        self._feats = self._feats[m:]
        self._idx = self._idx[m:]
        return idx


class _BatchedStreamEngine:
    """Shared multi-stream machinery: one source per stream (a
    ``_FeatureQueue`` on the host frontend, a ``WaveStreamBuffer`` with
    ``device_frontend``), lockstep step/flush scheduling, reset masks
    and the batched step function.

    Subclasses call ``_setup(...)`` and implement ``_dispatch(ready, t,
    feats, active, reset, tvalid)`` (one batched device step +
    per-stream results) and ``_reset_host_state(stream)``."""

    def _setup(self, ckpt_path, config, num_streams: int, step_frames: int,
               use_fused: Optional[bool], device_frontend: bool,
               softmax: bool, device):
        """Load the model and build the step function:
        ``_step_fn((x, lo), active, reset, cache) -> (probs, cache')``,
        ``x`` the sources' windows: ``(N, T, D)`` features or, with
        ``device_frontend``, ``(N, W)`` waves featurized in the step.
        ``use_fused=None`` takes ``forward_route``'s route for the loaded
        model.  ``device`` is one device or a list of them; over several
        the step is ``_split_rows`` of one step function a device.
        Returns the configs."""
        if num_streams < 1 or step_frames < 1:
            raise ValueError("num_streams and step_frames must be >= 1")
        self.devices = [resolve_device(d) for d in (
            device if isinstance(device, (list, tuple)) else [device])]
        if num_streams % len(self.devices):
            raise ValueError(f"num_streams ({num_streams}) must be a "
                             f"multiple of the {len(self.devices)} devices")
        self.device = self.devices[0]
        self.rows = num_streams // len(self.devices)
        self.device_frontend = device_frontend
        configs, cfg, left, right, downsampling = load_spotter_config(config)
        self.sample_rate = cfg.sample_rate
        # frontend frame indices are global pre-skip indices, so wall
        # time is idx * frame_shift
        self.resolution = cfg.frame_shift_ms / 1000.0
        self.downsampling = downsampling
        self._frontend_args = (cfg, left, right, downsampling)
        self.feat_dim = cfg.feat_dim * (left + 1 + right)
        self.models = [load_serving_model(configs, ckpt_path,
                                          self.feat_dim, dev)
                       for dev in self.devices]
        parts = [self._device_step(j, use_fused, softmax, step_frames)
                 for j in range(len(self.devices))]
        if len(parts) == 1:
            self._step_fn, self.cache = parts[0]
        else:
            self._step_fn = _split_rows([fn for fn, _ in parts], self.rows)
            self.cache = tuple(c for _, c in parts)
        if device_frontend:
            self._window_shape = (self._featurizer(self.device,
                                                   step_frames)[1],)
            self.sources = [
                WaveStreamBuffer(cfg.frame_shift, cfg.frame_length, left,
                                 right, downsampling, step_frames)
                for _ in range(num_streams)
            ]
        else:
            self._window_shape = (step_frames, self.feat_dim)
            self.sources = [
                _FeatureQueue(self._frontend_args, self.feat_dim,
                              step_frames)
                for _ in range(num_streams)
            ]
        self.num_streams = num_streams
        self.step_frames = step_frames
        self._reset_mask = np.zeros((num_streams,), bool)
        # overflow events beyond the one-result-per-step contract
        self._event_backlog: List[List[Dict]] = [
            [] for _ in range(num_streams)
        ]
        # every _run() counts here, whichever public path invoked it
        self.stats = {"dispatches": 0, "rows": 0, "frames": 0,
                      "dispatch_s": 0.0}
        return configs

    def _featurizer(self, dev, step_frames: int):
        cfg, left, right, downsampling = self._frontend_args
        return build_batch_featurizer(cfg, left, right, downsampling,
                                      step_frames, dev)

    @property
    def model(self):
        """The loaded model (the first device's copy)."""
        return self.models[0]

    def _device_step(self, j: int, use_fused, softmax, step_frames: int):
        """(step function, cache) of device j's ``self.rows`` streams on
        its copy of the model, by the route ``use_fused`` picks."""
        dev, model = self.devices[j], self.models[j]
        if use_fused_stream(model, dev, use_fused, forward_route):
            fused = build_fused_stream(model, softmax=softmax, device=dev)
            if fused is None:
                raise ValueError(
                    "use_fused=True: this model is not supported by the "
                    "fused stream (needs a DS-TCN or MDTC with linear "
                    "preprocessing or an FSMN, and a linear, element or "
                    "identity head)")
            apply, init_cache = fused
            cache, row_axis = init_cache(self.rows), 1
        else:
            def apply(feats, cache):
                return self.models[j](feats, cache, softmax=softmax)

            cache, row_axis = model.init_cache(self.rows, dev), 0
        featurize = (self._featurizer(dev, step_frames)[0]
                     if self.device_frontend else None)
        zero = torch.zeros((), device=dev)

        def step_fn(feats, active, reset, cache):
            with torch.inference_mode():
                x, lo = feats
                if featurize is not None:
                    feats = featurize(x, lo)  # waves -> features
                else:
                    feats = torch.as_tensor(x, device=dev)
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

        return step_fn, cache

    # ------------- streaming -------------

    def accept_wave(self, stream: int, wave: bytes) -> None:
        """Queue a PCM chunk (int16 LE bytes) for one stream."""
        self.sources[stream].append(
            np.frombuffer(wave, dtype="<i2").astype(np.float32))

    def pending_frames(self, stream: int) -> int:
        return self.sources[stream].available_outputs()

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
                # flush() keeps the last result per stream; a caller
                # that must see every overflow event drains through
                # step()/flush_stream() (the serving daemon's path)
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
        n = self.num_streams
        active = np.zeros((n,), bool)
        tvalid: Dict[int, int] = {}
        for i in ready:
            k = t
            if lengths is not None and i in lengths:
                k = min(int(lengths[i]), t)
            active[i] = True
            tvalid[i] = k
        # fixed-shape windows: (T, D) features, or waves featurized in
        # the step function (runtime/device_frontend.py geometry)
        x = np.zeros((n,) + self._window_shape, np.float32)
        lo = np.zeros((n,), np.int64)
        for i in ready:
            x[i], lo[i] = self.sources[i].window()
        feats = (x, lo)
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
        return self.sources[stream].consume(t)

    def _first_idx(self, stream: int) -> int:
        """Absolute (pre-skip spliced) index of the next queued frame."""
        return self.sources[stream].next_index

    # ------------- state -------------

    def reset_stream(self, stream: int) -> None:
        """Free a slot for a new client: clears frontend, queue, decode
        state and (on the next step) the cache row."""
        self._reset_host_state(stream)
        self.sources[stream].reset()
        self._reset_mask[stream] = True

    def reset_all(self) -> None:
        for i in range(self.num_streams):
            self.reset_stream(i)

    def _dispatch(self, ready, t, feats, active, reset, tvalid):
        raise NotImplementedError

    def _reset_host_state(self, stream: int) -> None:
        raise NotImplementedError


class BatchKeywordSpotter(_BatchedStreamEngine):
    """Batched multi-stream CTC keyword spotting.

    ``config`` is a resolved train config, as a dict or a YAML path;
    ``ckpt_path`` a port ``.pt`` or a JAX-package ``.ckpt`` (a float32
    model whatever ``model.dtype`` says) or an exported artifact
    directory.  Runs on ``device``, CUDA unless the caller asks for the
    CPU, or split over a list of devices.  ``set_keywords`` must come
    before the first step with ``device_decode``."""

    def __init__(
        self,
        ckpt_path: str,
        config,
        token_path: str,
        lexicon_path: Optional[str],
        threshold: float,
        num_streams: int = 16,
        step_frames: int = 8,
        min_frames: int = 5,
        max_frames: int = 250,
        interval_frames: int = 50,
        score_beam: int = 3,
        path_beam: int = 20,
        device_decode: bool = False,
        device_frontend: bool = False,
        max_prefix: int = 32,
        use_fused: Optional[bool] = False,
        device="cuda",
    ):
        self.device_decode = device_decode
        configs = self._setup(ckpt_path, config, num_streams, step_frames,
                              use_fused, device_frontend, True, device)
        self._fsm = dict(
            threshold=float(threshold),
            min_frames=int(min_frames),
            max_frames=int(max_frames),
            interval_frames=int(interval_frames),
            downsampling=int(self.downsampling),
            score_beam=int(score_beam),
        )
        self._vocab = int(configs["model"]["output_dim"])
        self._kw_arrays = None  # one tuple a device
        self._kw_names: List[str] = []
        self._dstates = None  # one decode state a device
        if device_decode:
            self._dstates = [init_stream_state(self.rows, path_beam,
                                               max_prefix, dev)
                             for dev in self.devices]

        self.token_table = read_token(token_path)
        self.lexicon_table = (
            read_lexicon(lexicon_path) if lexicon_path else {}
        )
        self.detectors: List[StreamDetector] = [
            StreamDetector(
                threshold, min_frames, max_frames, interval_frames,
                score_beam, path_beam, self.resolution, self.downsampling,
            )
            for _ in range(num_streams)
        ]

    # ------------- keywords -------------

    def set_keywords(self, keywords: str) -> None:
        """Shared keyword set for every stream slot."""
        tables = build_keyword_tables(
            keywords, self.token_table, self.lexicon_table
        )
        for det in self.detectors:
            det.set_tables(*tables)
        if self.device_decode:
            kw_tok, kw_len, mask, names = make_keyword_arrays(
                tables[0], self._vocab)
            self._kw_arrays = [(
                torch.as_tensor(kw_tok, dtype=torch.int64, device=dev),
                torch.as_tensor(kw_len, dtype=torch.int64, device=dev),
                torch.as_tensor(mask, device=dev),
            ) for dev in self.devices]
            self._kw_names = names

    # ------------- streaming -------------

    def _dispatch(self, ready, t, feats, active, reset,
                  tvalid) -> Dict[int, Dict]:
        if self.device_decode:
            return self._run_device(ready, feats, active, reset, tvalid)
        probs, self.cache = self._step_fn(feats, active, reset, self.cache)
        probs = _host_rows(probs)  # (N, T, V)
        results: Dict[int, Dict] = {}
        for i in ready:
            k = tvalid[i]
            idx = self._consume(i, k)
            results[i] = self.detectors[i].process(idx, probs[i][:k])
        return results

    def _combined_fn(self, feats, active, reset, t0, lens):
        """The model step and ``stream_detect_step`` in one function;
        returns the packed ``(5, rows)`` float32 events of each device
        (fired, keyword, start, end, score; frame indices are below
        2**24, exact in float32), every device's work enqueued first."""
        probs, self.cache = self._step_fn(feats, active, reset, self.cache)
        blocks = [probs] if isinstance(probs, torch.Tensor) else probs
        out = []
        for j, (dev, p) in enumerate(zip(self.devices, blocks)):
            rows = slice(j * self.rows, (j + 1) * self.rows)
            with torch.inference_mode():
                self._dstates[j], events = stream_detect_step(
                    self._dstates[j], p,
                    torch.as_tensor(active[rows], device=dev),
                    torch.as_tensor(reset[rows], device=dev),
                    torch.as_tensor(t0[rows], device=dev),
                    *self._kw_arrays[j],
                    lengths=torch.as_tensor(lens[rows], device=dev),
                    **self._fsm)
                out.append(torch.stack([
                    events["fired"].to(torch.float32),
                    events["kw"].to(torch.float32),
                    events["start"].to(torch.float32),
                    events["end"].to(torch.float32),
                    events["score"],
                ]))
        return out

    def _run_device(self, ready, feats, active, reset,
                    tvalid) -> Dict[int, Dict]:
        """One step: model + beam + FSM on the device; the host reads
        the (5, N) events in one copy."""
        if self._kw_arrays is None:
            raise RuntimeError(
                "device_decode requires set_keywords() before step()"
            )
        n = self.num_streams
        t0 = np.zeros((n,), np.int64)
        lens = np.zeros((n,), np.int64)
        for i in ready:
            t0[i] = self._first_idx(i)
            lens[i] = tvalid[i]
        ev = np.concatenate([e.cpu().numpy() for e in self._combined_fn(
            feats, active, reset, t0, lens)], axis=1)

        results: Dict[int, Dict] = {}
        res = self.resolution
        for i in ready:
            self._consume(i, tvalid[i])
            if ev[0, i]:
                results[i] = {
                    "state": 1,
                    "keyword": self._kw_names[int(ev[1, i])],
                    "start": float(ev[2, i]) * res,
                    "end": float(ev[3, i]) * res,
                    "score": float(ev[4, i]),
                }
            else:
                results[i] = {
                    "state": 0, "keyword": None, "start": None,
                    "end": None, "score": None,
                }
        return results

    def _reset_host_state(self, stream: int) -> None:
        self.detectors[stream].reset_all()


class BatchMaxPoolSpotter(_BatchedStreamEngine):
    """Batched multi-stream serving for max-pooling wake-word models.

    A stream fires keyword k at the first frame whose sigmoid posterior
    reaches ``threshold``, then stays silent for that (stream, keyword)
    for ``interval_frames`` frames (compute_det's window_shift
    suppression).  ``config`` is a resolved train config, as a dict or
    a YAML path; ``ckpt_path`` a port ``.pt`` or a JAX-package ``.ckpt``
    (a float32 model whatever ``model.dtype`` says) or an exported
    artifact directory.  Runs on ``device``, CUDA unless the caller asks
    for the CPU, or split over a list of devices."""

    def __init__(
        self,
        ckpt_path: str,
        config,
        threshold: float,
        num_streams: int = 16,
        step_frames: int = 8,
        interval_frames: int = 50,
        keyword_names: Optional[List[str]] = None,
        use_fused: Optional[bool] = False,
        device_frontend: bool = False,
        device="cuda",
    ):
        configs = self._setup(ckpt_path, config, num_streams, step_frames,
                              use_fused, device_frontend, False, device)
        num_keywords = int(configs["model"]["output_dim"])
        self.keyword_names = keyword_names or [
            str(k) for k in range(num_keywords)
        ]
        if len(self.keyword_names) != num_keywords:
            raise ValueError("keyword_names must name every output")
        self.threshold = float(threshold)
        self.interval_frames = int(interval_frames)
        self._last_fire = np.full(
            (num_streams, num_keywords), -(10**9), np.int64
        )

    def _dispatch(self, ready, t, feats, active, reset,
                  tvalid) -> Dict[int, Dict]:
        probs, self.cache = self._step_fn(feats, active, reset, self.cache)
        probs = _host_rows(probs)  # (N, T, K)

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
