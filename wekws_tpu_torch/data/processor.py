"""Host-side pipeline stages (chain of generators over sample dicts).

Copy of wekws_tpu/data/processor.py.  Stage semantics mirror the
reference wekws processors (wekws/dataset/processor.py) but operate on
numpy waveforms and STOP at the waveform level: feature extraction,
spec_aug, context expansion and frame skipping all run **on the
device** inside the train step (data/device_pipeline.py).  Host
stages: parse -> filter -> resample -> speed_perturb -> reverb/noise
-> shuffle -> batch (bucket-padded).

Sample dict: {key, txt, wav (np.float32 [-1,1]), sample_rate, label,
label length}.  Batches are dicts of fixed-shape numpy arrays.
"""

import json
import logging
import random
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from wekws_tpu_torch.data import audio
from wekws_tpu_torch.data.blobstore import BlobData


def parse_raw(data: Iterable[dict]) -> Iterator[dict]:
    """JSONL {key, wav, txt[, duration]} lines -> loaded samples.

    Unreadable files are skipped with a warning (processor.py:55-56)."""
    for sample in data:
        obj = json.loads(sample["src"]) if "src" in sample else sample
        try:
            wave, sr = audio.read_wav(obj["wav"])
        except Exception:
            logging.warning("Failed to read %s", obj.get("wav"))
            continue
        yield dict(
            key=obj["key"], txt=obj["txt"], wav=wave, sample_rate=sr
        )


def tokenize(data: Iterable[dict], tokenizer) -> Iterator[dict]:
    """txt -> label.  With a tokenizer (CTC), txt ALWAYS tokenizes —
    numeric-looking transcripts (e.g. digit token names) must not be
    misread as class indices.  Without one, integer txt is the CE /
    max-pooling class index."""
    for sample in data:
        txt = sample["txt"]
        if tokenizer is not None:
            _, ids = tokenizer.tokenize(str(txt))
            sample["label"] = list(ids)
        elif isinstance(txt, int) or (
            isinstance(txt, str) and txt.lstrip("-").isdigit()
        ):
            sample["label"] = int(txt)
        else:
            # raw text label with no tokenizer (e.g. scoring paths that
            # only need keys): filler id, the txt stays on the sample
            sample["label"] = -1
        yield sample


def filter_length(
    data: Iterable[dict],
    max_length: int = 10240,
    min_length: int = 10,
    token_max_length: int = 200,
    token_min_length: int = 1,
    **unused,
) -> Iterator[dict]:
    """Drop samples outside [min, max] length in 10ms frames and (for
    token-sequence labels) outside token-count bounds."""
    for sample in data:
        num_frames = len(sample["wav"]) / sample["sample_rate"] * 100
        if num_frames < min_length or num_frames > max_length:
            continue
        label = sample.get("label")
        if isinstance(label, list):
            if not (token_min_length <= len(label) <= token_max_length):
                continue
        yield sample


def resample(data: Iterable[dict], resample_rate: int = 16000) -> Iterator[dict]:
    for sample in data:
        if sample["sample_rate"] != resample_rate:
            sample["wav"] = audio.resample(
                sample["wav"], sample["sample_rate"], resample_rate
            )
            sample["sample_rate"] = resample_rate
        yield sample


def speed_perturb(
    data: Iterable[dict], speeds: Optional[List[float]] = None
) -> Iterator[dict]:
    if speeds is None:
        speeds = [0.9, 1.0, 1.1]
    for sample in data:
        speed = random.choice(speeds)
        if speed != 1.0:
            sample["wav"] = audio.speed_perturb(sample["wav"], speed)
        yield sample


class _DecodeCache:
    """Small keyed cache of decoded augmentation-corpus waveforms.

    Noise/RIR stores hold a few dozen entries but are sampled once per
    utterance; decoding the same wav bytes every draw would dominate
    the aug pipeline.  Identical numerics — it only memoizes
    read_wav."""

    def __init__(self, max_items: int = 256):
        self.max_items = max_items
        self.data: Dict = {}

    def get(self, key, compute):
        if key not in self.data:
            if len(self.data) >= self.max_items:
                self.data.pop(next(iter(self.data)))
            self.data[key] = compute()
        return self.data[key]


def add_reverb(
    data: Iterable[dict], reverb_source: BlobData, aug_prob: float
) -> Iterator[dict]:
    """Convolve with a random RIR (L2-normalized), truncated to the
    original length (processor.py:374-392).

    Same math as scipy.signal.fftconvolve(mode='full')[:len(wave)] —
    rfft/irfft at next_fast_len — but the normalized RIR and its
    spectrum are cached per (rir, fft size), halving FFT work."""
    from scipy.fft import irfft, next_fast_len, rfft

    rir_cache = _DecodeCache()
    spec_cache = _DecodeCache()
    for sample in data:
        if aug_prob > random.random():
            wave = sample["wav"]
            key, rir_bytes = reverb_source.random_one()

            def decode():
                rir, _ = audio.read_wav(rir_bytes)
                norm = np.sqrt(np.sum(rir ** 2))
                return rir / norm if norm > 0 else None

            rir = rir_cache.get(key, decode)
            if rir is not None:
                nfft = next_fast_len(len(wave) + len(rir) - 1)
                rir_f = spec_cache.get(
                    (key, nfft), lambda: rfft(rir, nfft)
                )
                out = irfft(rfft(wave, nfft) * rir_f, nfft)
                sample["wav"] = out[: len(wave)].astype(np.float32)
        yield sample


_SNR_RANGES = {"noise": (0, 15), "speech": (5, 30), "music": (5, 15)}


def snr_range_for_key(key: str) -> tuple:
    """Per-corpus SNR range from the noise key, reference semantics:
    ``key.startswith('noise'|'speech'|'music')`` (processor.py:404-411),
    so musan-style keys without underscores ('speech-librivox-0001')
    resolve correctly.  Checked on the raw key AND its basename (our
    blobstore keys may carry a path prefix the reference's lmdb keys
    don't)."""
    base = str(key).split("/")[-1]
    for prefix, rng in _SNR_RANGES.items():
        if base.startswith(prefix):
            return rng
    return (0, 15)


def add_noise(
    data: Iterable[dict], noise_source: BlobData, aug_prob: float
) -> Iterator[dict]:
    """Additive noise at an SNR drawn per noise-key prefix
    (processor.py:395-430)."""
    cache = _DecodeCache()
    for sample in data:
        if aug_prob > random.random():
            wave = sample["wav"]
            n = len(wave)
            key, noise_bytes = noise_source.random_one()
            lo, hi = snr_range_for_key(key)
            noise = cache.get(key, lambda: audio.read_wav(noise_bytes)[0])
            if len(noise) > n:
                start = random.randint(0, len(noise) - n)
                noise = noise[start : start + n]
            else:
                noise = np.resize(noise, (n,))
            audio_db = 10 * np.log10(np.mean(wave ** 2) + 1e-4)
            noise_db = 10 * np.log10(np.mean(noise ** 2) + 1e-4)
            snr = random.uniform(lo, hi)
            scale = np.sqrt(10 ** ((audio_db - noise_db - snr) / 10))
            sample["wav"] = (wave + scale * noise).astype(np.float32)
        yield sample


def shuffle(data: Iterable[dict], shuffle_size: int = 1000) -> Iterator[dict]:
    buf = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= shuffle_size:
            random.shuffle(buf)
            yield from buf
            buf = []
    random.shuffle(buf)
    yield from buf


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _emit_batch(
    samples: List[dict],
    smax: int,
    wave_scale: float,
    n_fill: int = 0,
    fixed_label_len: int = 0,
    wire_dtype: str = "float32",
) -> Dict[str, np.ndarray]:
    """Assemble fixed-shape arrays from ``samples`` (+ ``n_fill``
    zero rows marked invalid).  ``fixed_label_len`` forces the
    label-pad width exactly (bucketed lockstep batches must agree on
    it globally; a label list longer than the cap is an assertion
    error — upstream filter_length keeps that unreachable).

    ``wire_dtype='int16'`` emits waves as int16 (batch_conf knob):
    halves batch assembly, worker-queue pickling, and H2D bytes.  For
    unaugmented wavs the round-trip is EXACT (they are int16 on disk
    and wave_scale restores the stored integers); augmented waves gain
    <=0.5 LSB rounding — over an order of magnitude below the training
    dither (1.0 in the same int16 scale).  The device pipeline casts
    back to f32 (features are computed in f32 either way)."""
    b = len(samples) + n_fill
    int16_wire = wire_dtype == "int16"
    waves = np.zeros((b, smax), np.int16 if int16_wire else np.float32)
    lengths = np.ones((b,), np.int32)  # fill rows: 1 sample, no NaNs
    valid = np.zeros((b,), np.float32)
    for i, s in enumerate(samples):
        n = len(s["wav"])
        scaled = s["wav"] * wave_scale
        if int16_wire:
            scaled = np.clip(np.rint(scaled), -32768, 32767)
        waves[i, :n] = scaled
        lengths[i] = n
        valid[i] = 0.0 if s.get("_fill") else 1.0
    labels = [s.get("label", 0) for s in samples]
    # fixed_label_len > 0 forces the token-sequence layout even for an
    # all-fill batch (all processes must agree on the target rank)
    if (labels and isinstance(labels[0], list)) or fixed_label_len:
        labels = [ln if isinstance(ln, list) else [ln] for ln in labels]
        umax = fixed_label_len or max(
            max((len(ln) for ln in labels), default=1), 1
        )
        target = np.full((b, umax), -1, np.int32)
        target_lengths = np.ones((b,), np.int32)
        for i, lab in enumerate(labels):
            # self-enforce the invariant instead of silently truncating
            # (upstream filter_length caps token counts; a config that
            # breaks that must fail loudly, not corrupt CTC targets)
            assert len(lab) <= umax, (
                f"label of {samples[i]['key']} has {len(lab)} tokens > "
                f"fixed_label_len {umax}; raise dataset_conf."
                f"batch_conf.fixed_label_len or tighten filter_conf"
            )
            target[i, : len(lab)] = lab
            target_lengths[i] = max(len(lab), 1)
    else:
        target = np.zeros((b,), np.int32)
        target[: len(labels)] = np.asarray(labels, np.int32)
        target_lengths = np.ones((b,), np.int32)
    return dict(
        keys=[s["key"] for s in samples] + ["<fill>"] * n_fill,
        waves=waves,
        wave_lengths=lengths,
        target=target,
        target_lengths=target_lengths,
        valid=valid,
    )


def batch(
    data: Iterable[dict],
    batch_size: int = 16,
    bucket_samples: int = 16000,
    max_label_len_default: int = 1,
    drop_last: bool = False,
    wave_scale: float = 32768.0,
    fixed_samples: int = 0,
    wire_dtype: str = "float32",
) -> Iterator[Dict[str, np.ndarray]]:
    """Batch samples into fixed-shape arrays.

    Waveforms are padded to the next multiple of ``bucket_samples`` of
    the batch max so XLA sees a small, bounded set of shapes (SURVEY.md
    §7 hard part (d)), and scaled to int16 range (the training feature
    convention, processor.py:194: wave * (1 << 15)).
    ``fixed_samples`` pads EVERY batch to one sample count (and drops
    longer utterances) — the simplest multi-host lockstep shape policy
    (``bucket_batch`` below is the efficient one).

    Yields {keys, waves (B,S), wave_lengths (B,), target,
    target_lengths, valid}.  Integer labels -> target (B,); token
    sequences -> (B,U) padded -1.
    """
    buf: List[dict] = []
    if fixed_samples:
        data = (s for s in data if len(s["wav"]) <= fixed_samples)

    def emit(samples: List[dict]) -> Dict[str, np.ndarray]:
        smax = fixed_samples or round_up(
            max(len(s["wav"]) for s in samples), bucket_samples
        )
        return _emit_batch(samples, smax, wave_scale,
                           wire_dtype=wire_dtype)

    for sample in data:
        buf.append(sample)
        if len(buf) >= batch_size:
            yield emit(buf)
            buf = []
    if buf and not drop_last:
        yield emit(buf)


def bucket_batch(
    data: Iterable[dict],
    batch_size: int,
    bucket_boundaries: List[int],
    schedule: List[int],
    wave_scale: float = 32768.0,
    fill: str = "duplicate",
    buffer_cap: int = 0,
    max_label_len: int = 1,
    wire_dtype: str = "float32",
) -> Iterator[Dict[str, np.ndarray]]:
    """Length-bucketed batching under a fixed global schedule.

    Multi-host SPMD training requires every process to contribute an
    identically shaped shard each step, WITHOUT communicating.  Padding
    every utterance to the global cap (``fixed_samples``) satisfies
    that at ~10x wasted compute for typical KWS corpora (2 s median
    utterances vs a 20 s cap).  Instead, all processes follow the same
    precomputed ``schedule`` of bucket indices (epoch-seeded, built
    from globally known data — see Dataset.make_bucket_schedule), so at
    step k every process emits a batch padded only to
    ``bucket_boundaries[schedule[k]]``.

    Each process fills the scheduled bucket from its own stream via
    per-bucket queues.  When the scheduled bucket cannot be filled
    (distribution skew, filtered samples, stream end), rows are filled
    with:

      * ``fill='duplicate'`` (train): repeats of already-seen samples
        that fit the bucket — the same duplicate-sample semantics as
        the reference DistributedSampler's wraparound equalization
        (wekws/dataset/dataset.py); falls back to
        invalid zero rows when nothing has been seen yet.
      * ``fill='invalid'`` (cv/test): zero rows with ``valid=0`` so the
        exact-accounting cv loop excludes them.

    Samples longer than the last boundary are dropped (as with
    ``fixed_samples``).  ``buffer_cap`` bounds queued samples; on
    overflow the longest queue is trimmed (dropped samples reappear in
    a later epoch's shuffle).  Emits exactly ``len(schedule)`` batches
    of static shape (batch_size, boundary) — deterministic step count
    regardless of how many samples survive upstream filters, which the
    fixed_samples path could not guarantee.
    """
    boundaries = sorted(bucket_boundaries)
    nb = len(boundaries)
    queues: List[List[dict]] = [[] for _ in range(nb)]
    seen: List[List[dict]] = [[] for _ in range(nb)]  # duplicate pool
    buffer_cap = buffer_cap or 64 * batch_size
    it = iter(data)
    exhausted = False

    def bucket_of(n: int) -> int:
        for j, bound in enumerate(boundaries):
            if n <= bound:
                return j
        return -1

    def buffered() -> int:
        return sum(len(q) for q in queues)

    def pull_until(b: int) -> None:
        nonlocal exhausted
        while (
            not exhausted
            and len(queues[b]) < batch_size
            and (fill == "invalid" or buffered() < buffer_cap)
        ):
            # fill='invalid' (cv/test): NEVER stop buffering — every
            # sample must reach its scheduled slot (exact accounting);
            # the planned schedule bounds the real high-water mark
            try:
                s = next(it)
            except StopIteration:
                exhausted = True
                return
            j = bucket_of(len(s["wav"]))
            if j >= 0:
                queues[j].append(s)
        if (
            fill == "duplicate"
            and len(queues[b]) < batch_size
            and buffered() >= buffer_cap
        ):
            # train-mode pressure valve: trim the longest queue; the
            # dropped samples reappear in a later epoch's shuffle
            longest = max(range(nb), key=lambda j: len(queues[j]))
            if longest != b and queues[longest]:
                drop = len(queues[longest]) // 2
                logging.warning(
                    "bucket_batch: buffer cap %d hit while filling "
                    "bucket %d; dropping %d buffered samples from "
                    "bucket %d (rebalanced next epoch)",
                    buffer_cap, b, drop, longest,
                )
                del queues[longest][:drop]

    for b in schedule:
        pull_until(b)
        rows = queues[b][:batch_size]
        del queues[b][:batch_size]
        n_short = batch_size - len(rows)
        if n_short:
            # real data from shorter buckets first (extra padding only)
            for j in range(b - 1, -1, -1):
                take = queues[j][:n_short]
                del queues[j][:n_short]
                rows.extend(take)
                n_short = batch_size - len(rows)
                if not n_short:
                    break
        if n_short and fill == "duplicate":
            pool = [s for j in range(b + 1) for s in seen[j]]
            if pool:
                for i in range(n_short):
                    rows.append(pool[i % len(pool)])
                n_short = 0
        for s in rows:
            j = bucket_of(len(s["wav"]))
            pool = seen[j]
            pool.append(s)
            if len(pool) > batch_size:
                del pool[: len(pool) - batch_size]
        yield _emit_batch(
            rows, boundaries[b], wave_scale, n_fill=n_short,
            fixed_label_len=max_label_len, wire_dtype=wire_dtype,
        )
