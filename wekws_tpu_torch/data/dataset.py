"""Dataset composition: data.list -> shard -> stages -> batches.

Copy of wekws_tpu/data/dataset.py: one numpy pipeline (in place of the
reference wekws's two data paths, wekws/dataset/init_dataset.py and
dataset.py) that ends at padded waveform batches; features are
computed on the device (device_pipeline.py).  It imports no torch, so
spawned loader workers start light and never touch CUDA.

Sharding follows the reference DistributedSampler: the epoch-seeded
shuffled file list is sliced ``rank::world_size`` (the caller's rank
and world size; 0 and 1 on one card) — per-epoch reshuffling via
``set_epoch``.
"""

import copy
import random
from typing import Iterator, List, Optional

from wekws_tpu_torch.data import processor
from wekws_tpu_torch.data.blobstore import open_store


class DataList:
    """Epoch-aware sharded view of a list of JSONL lines."""

    def __init__(
        self,
        lines: List[str],
        shuffle: bool = True,
        partition: bool = True,
        rank: int = 0,
        world_size: int = 1,
    ):
        self.lines = lines
        self.shuffle = shuffle
        self.partition = partition
        self.rank = rank
        self.world_size = world_size
        self.worker_id = 0
        self.num_workers = 1
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def set_worker(self, worker_id: int, num_workers: int) -> None:
        """Second-level sharding across loader workers (the reference's
        rank -> worker two-level slicing, dataset.py:82-97)."""
        self.worker_id = worker_id
        self.num_workers = num_workers

    def shard_size(self) -> int:
        """Per-process sample count after wraparound equalization —
        identical on every process (the basis for deterministic
        lockstep batch counts)."""
        n = len(self.lines)
        if not self.partition or self.world_size <= 1:
            return n
        if n % self.world_size:
            n += self.world_size - n % self.world_size
        return n // self.world_size

    def __iter__(self) -> Iterator[dict]:
        data = list(range(len(self.lines)))
        if self.shuffle:
            random.Random(self.epoch).shuffle(data)
        if self.partition:
            if self.world_size > 1 and len(data) % self.world_size:
                # equalize shard sizes by wraparound so every process
                # sees the same number of batches (multi-host training
                # steps must stay in lockstep)
                data = data + data[: self.world_size
                                   - len(data) % self.world_size]
            data = data[self.rank :: self.world_size]
        if self.num_workers > 1:
            data = data[self.worker_id :: self.num_workers]
        for i in data:
            yield {"src": self.lines[i]}


class Dataset:
    """Composable host pipeline yielding fixed-shape numpy batches."""

    def __init__(
        self,
        data_list_file: str,
        conf: dict,
        tokenizer=None,
        split: str = "train",
        rank: int = 0,
        world_size: int = 1,
        seed: int = 777,
    ):
        conf = copy.deepcopy(conf)
        if split != "train":
            scrub_conf(conf)
        self.conf = conf
        self.split = split
        self.tokenizer = tokenizer
        self.seed = seed
        with open(data_list_file, "r", encoding="utf8") as f:
            lines = [line.strip() for line in f if line.strip()]
        self.data_list = DataList(
            lines,
            shuffle=conf.get("shuffle", split == "train"),
            partition=(split != "test"),
            rank=rank,
            world_size=world_size,
        )
        self._noise_store = None
        self._reverb_store = None
        if split == "train":
            if conf.get("noise_prob", 0) > 0 and conf.get("noise_source"):
                self._noise_store = open_store(conf["noise_source"], seed)
            if conf.get("reverb_prob", 0) > 0 and conf.get("reverb_source"):
                self._reverb_store = open_store(conf["reverb_source"], seed)
        bc = conf.get("batch_conf", {})
        self.bucket_boundaries = sorted(bc.get("bucket_boundaries", []))
        # ordered=True tells the DataLoader that batch ORDER is part of
        # the contract (the bucket schedule): worker outputs must merge
        # round-robin, not in arrival order
        self.ordered = bool(self.bucket_boundaries)
        self._bucket_weights_cache = None
        self._bucket_samples_cache = None

    def _bucket_samples(self) -> List[Optional[int]]:
        """Per-line sample counts from the ``duration`` fields, parsed
        ONCE (durations never change across epochs — re-parsing the
        whole list every epoch per worker is O(N * epochs * workers)
        wasted host time).  None entries mark missing durations."""
        if self._bucket_samples_cache is None:
            import json as _json

            sr = self.conf.get("resample_conf", {}).get(
                "resample_rate", 16000
            )
            out: List[Optional[int]] = []
            for line in self.data_list.lines:
                try:
                    d = _json.loads(line).get("duration")
                except Exception:
                    d = None
                out.append(None if d is None else int(float(d) * sr))
            self._bucket_samples_cache = out
        return self._bucket_samples_cache

    def _bucket_of(self, n: int) -> int:
        for j, bound in enumerate(self.bucket_boundaries):
            if n <= bound:
                return j
        return -1  # dropped upstream

    def bucket_weights(self) -> List[float]:
        """Per-bucket sample-count weights from the ``duration`` fields
        of the (global, identical-on-every-process) data list.  Falls
        back to uniform when durations are absent — then the schedule
        still guarantees lockstep, just with more fill rows."""
        if self._bucket_weights_cache is not None:
            return self._bucket_weights_cache
        counts = [0] * len(self.bucket_boundaries)
        n_dur = 0
        for samples in self._bucket_samples():
            if samples is None:
                continue
            n_dur += 1
            j = self._bucket_of(samples)
            if j >= 0:
                counts[j] += 1
        if n_dur < max(1, len(self.data_list.lines) // 2) or not sum(counts):
            weights = [1.0] * len(self.bucket_boundaries)
        else:
            weights = [max(c, 1e-9) for c in counts]
        self._bucket_weights_cache = weights
        return weights

    def _planned_bucket_counts(
        self, epoch: int, num_workers: int = 1
    ) -> Optional[List[List[List[int]]]]:
        """``counts[rank][worker][bucket]`` sample counts, reconstructed
        exactly by EVERY process from shared inputs (global list +
        durations + epoch seed): shard/worker assignment is a
        deterministic function of Random(epoch).shuffle over the full
        index list, so each process can simulate all ranks' and
        workers' shards.  Returns None when any duration is missing
        (fallback schedules apply)."""
        durs = self._bucket_samples()
        if any(d is None for d in durs):
            return None
        nb = len(self.bucket_boundaries)
        dl = self.data_list
        idx = list(range(len(durs)))
        if dl.shuffle:
            random.Random(epoch).shuffle(idx)
        world = dl.world_size if dl.partition else 1
        if dl.partition and world > 1 and len(idx) % world:
            idx = idx + idx[: world - len(idx) % world]
        counts = [
            [[0] * nb for _ in range(num_workers)] for _ in range(world)
        ]
        for r in range(world):
            shard = idx[r::world] if dl.partition else idx
            for w in range(num_workers):
                for i in shard[w::num_workers]:
                    j = self._bucket_of(durs[i])
                    if j >= 0:
                        counts[r][w][j] += 1
        return counts

    def make_bucket_schedule(
        self, epoch: int, worker_id: int = 0, num_workers: int = 1
    ) -> List[int]:
        """The bucket-index schedule of loader worker ``worker_id`` for
        ``epoch`` — every process computes the identical list from
        shared inputs only: seed, epoch, global list length, durations,
        config.  (All ranks must run the same ``num_workers``; the
        rank-level shape sequence is the round-robin interleave of the
        worker schedules.)

        With durations present the schedule allocates, per (worker,
        bucket), the max over ranks of the batches that rank's worker
        needs — every sample is guaranteed a slot IN ITS OWN WORKER
        (exact cv accounting even under worker sharding; slot ownership
        must match sample ownership, a global schedule sliced
        ``[w::W]`` would strand samples in workers that own no slot for
        their bucket).  Train order is shuffled; cv runs buckets
        back-to-back.  Without durations: train falls back to weighted
        random draws sliced per worker (duplicate fill absorbs the
        mismatch), cv to all-cap batches sized by the worker's own
        shard (always exact)."""
        bc = self.conf.get("batch_conf", {})
        batch_size = bc.get("batch_size", 16)
        nb = len(self.bucket_boundaries)
        counts = self._planned_bucket_counts(epoch, num_workers)
        if counts is not None:
            per_bucket = [
                max(
                    (c[worker_id][j] + batch_size - 1) // batch_size
                    for c in counts
                )
                for j in range(nb)
            ]
            schedule = [
                j for j in range(nb) for _ in range(per_bucket[j])
            ]
            if self.split == "train":
                random.Random(
                    self.seed * 1000003 + epoch * 1009 + worker_id
                ).shuffle(schedule)
            return schedule or [nb - 1]
        shard = self.data_list.shard_size()
        if self.split != "train":
            # worker w owns len(range(w, shard, W)) samples — identical
            # on every rank since shard sizes are equalized
            own = len(range(worker_id, shard, num_workers))
            return [nb - 1] * max((own + batch_size - 1) // batch_size, 1)
        n_batches = max((shard + batch_size - 1) // batch_size, 1)
        rnd = random.Random(self.seed * 1000003 + epoch)
        draws = rnd.choices(
            range(nb), weights=self.bucket_weights(), k=n_batches
        )
        return draws[worker_id::num_workers]

    def set_epoch(self, epoch: int) -> None:
        self.data_list.set_epoch(epoch)
        # fold the worker id in: spawn workers inherit a pickled copy
        # of this dataset, so without it every worker would draw the
        # SAME augmentation sequence (speeds, aug coin flips, SNRs,
        # shuffles) on its disjoint shard — 1/num_workers the intended
        # augmentation diversity
        worker = getattr(self.data_list, "worker_id", 0)
        rank = getattr(self.data_list, "rank", 0)
        base = ((self.seed or 0) + epoch * 1009 + worker * 7919
                + rank * 104729)
        random.seed(base)
        # distinct per-store constants: identical seeds would make the
        # i-th RIR pick a deterministic function of the i-th noise pick
        for offset, store in ((1, self._noise_store),
                              (2, self._reverb_store)):
            if store is not None and hasattr(store, "_rng"):
                store._rng = random.Random(base * 1000003 + offset)

    def __iter__(self):
        conf = self.conf
        it = iter(self.data_list)
        it = processor.parse_raw(it)
        it = processor.tokenize(it, self.tokenizer)
        it = processor.filter_length(it, **conf.get("filter_conf", {}))
        it = processor.resample(
            it, conf.get("resample_conf", {}).get("resample_rate", 16000)
        )
        if self.split == "train":
            if conf.get("speed_perturb", False):
                it = processor.speed_perturb(it)
            if self._reverb_store is not None:
                it = processor.add_reverb(
                    it, self._reverb_store, conf.get("reverb_prob", 0.0)
                )
            if self._noise_store is not None:
                it = processor.add_noise(
                    it, self._noise_store, conf.get("noise_prob", 0.0)
                )
        if conf.get("shuffle", False):
            it = processor.shuffle(
                it, conf.get("shuffle_conf", {}).get("shuffle_size", 1000)
            )
        bc = conf.get("batch_conf", {})
        if self.bucket_boundaries:
            dl = self.data_list
            # per-worker schedule (round-robin merged by the loader)
            schedule = self.make_bucket_schedule(
                dl.epoch, dl.worker_id, max(dl.num_workers, 1)
            )
            fixed_label_len = bc.get("max_label_len", 0)
            if not fixed_label_len and self.tokenizer is not None:
                fixed_label_len = conf.get("filter_conf", {}).get(
                    "token_max_length", 200
                )
            it = processor.bucket_batch(
                it,
                batch_size=bc.get("batch_size", 16),
                bucket_boundaries=self.bucket_boundaries,
                schedule=schedule,
                fill="duplicate" if self.split == "train" else "invalid",
                buffer_cap=bc.get("bucket_buffer_cap", 0),
                max_label_len=fixed_label_len,
                wire_dtype=bc.get("wire_dtype", self._default_wire()),
            )
        else:
            it = processor.batch(
                it,
                batch_size=bc.get("batch_size", 16),
                bucket_samples=bc.get("bucket_samples", 16000),
                drop_last=bc.get("drop_last", self.split == "train"),
                fixed_samples=bc.get("fixed_samples", 0),
                wire_dtype=bc.get("wire_dtype", self._default_wire()),
            )
        return it

    def _default_wire(self) -> str:
        """int16 wire is bit-exact for unaugmented PCM; waveform
        augmentation (noise mix, reverb) can overshoot int16 range and
        would be hard-clipped, so aug pipelines default to float32
        (batch_conf.wire_dtype overrides either way)."""
        aug = self.split == "train" and (
            self.conf.get("speed_perturb", False)
            or self._noise_store is not None
            or self._reverb_store is not None
        )
        return "float32" if aug else "int16"


def scrub_conf(conf: dict) -> dict:
    """Disable augmentation/shuffle for cv/test
    (train.py:107-111, init_dataset.py:81-90 semantics)."""
    conf["speed_perturb"] = False
    conf["spec_aug"] = False
    conf["noise_prob"] = 0.0
    conf["reverb_prob"] = 0.0
    conf["shuffle"] = False
    for key in ("fbank_conf", "mfcc_conf", "feature_extraction_conf"):
        if key in conf:
            conf[key]["dither"] = 0.0
    return conf


def init_dataset(
    data_list_file: str,
    conf: dict,
    tokenizer=None,
    split: str = "train",
    **kwargs,
) -> Dataset:
    return Dataset(data_list_file, conf, tokenizer, split, **kwargs)
