"""Epoch-level training loop.

Port of wekws_tpu/train/executor.py: a one-epoch train loop and a cv
loop with loss/acc accumulation over the host pipeline's batches.  A
``DataLoader`` iterates itself (worker processes; the caller sets its
epoch); any other iterable of numpy batch dicts (a ``Dataset``, a list)
is run ahead of the device by the thread ``Prefetcher``.  cv counts
exactly: fill rows (``valid`` 0) and non-finite losses are left out.

``train_resident`` and ``cv_resident`` run epochs over a corpus staged
on the device (``data/resident.py``): one upload of the epoch's
(steps, B) row indices, then each step gathers its rows on the device.

Under data parallelism (``parallel/mesh.py``) each rank runs these
loops on its own rows: the host pipeline's batches come from its shard
of the list (the bucket schedule keeps the ranks' shapes and batch
counts in lockstep), a resident step takes the rank's slice of each
global index row, and cv's three sums and the epoch's audio seconds are
all-reduced once an epoch, so every rank logs the global figures and
the same cv loss.  As in the JAX package, ``decode_acc`` runs only with
one process.
"""

import json
import logging
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from wekws_tpu_torch.data.loader import DataLoader
from wekws_tpu_torch.data.prefetch import Prefetcher
from wekws_tpu_torch.data.resident import gather_rows
from wekws_tpu_torch.decode.accuracy import acc_utterance
from wekws_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    is_distributed,
    process_count,
    process_index,
)

# the early steps ``profile_dir`` traces: [start, stop)
PROFILE_STEPS = (3, 9)


class Executor:
    def __init__(self, trainer, log_interval: int = 10,
                 metrics_path: Optional[str] = None,
                 profile_dir: Optional[str] = None):
        """``metrics_path`` appends per-epoch JSONL records;
        ``profile_dir`` writes a torch.profiler trace of steps 3-8 of the
        first epoch trained (``PROFILE_STEPS``)."""
        self.trainer = trainer
        self.log_interval = log_interval
        self.metrics_path = metrics_path
        self.profile_dir = profile_dir
        self._profiled = False

    def log_metrics(self, record: Dict) -> None:
        if self.metrics_path:
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def _sync(self) -> None:
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)

    @staticmethod
    def _iterate(dataset: Iterable[Dict]):
        if isinstance(dataset, DataLoader):
            return iter(dataset)
        return iter(Prefetcher(dataset))

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.trainer.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def _stop_profile(self, prof) -> None:
        self._sync()
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.profile_dir,
                                              "trace.json"))
        self._profiled = True

    def _window(self, steps: Iterable):
        """``enumerate(steps)``, with the first epoch's ``PROFILE_STEPS``
        traced: the profiler starts before step ``start`` and stops
        after step ``stop - 1``, or at the end of a shorter epoch."""
        prof = None
        for idx, item in enumerate(steps):
            if self.profile_dir and not self._profiled \
                    and idx == PROFILE_STEPS[0]:
                prof = self._profiler()
                prof.start()
            yield idx, item
            if prof is not None and idx == PROFILE_STEPS[1] - 1:
                self._stop_profile(prof)
                prof = None
        if prof is not None:
            self._stop_profile(prof)

    def _log_batch(self, epoch: int, idx: int, metrics, lr: float,
                   losses: list, accs: list) -> None:
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m["loss"])
        accs.append(m["acc"])
        logging.info(
            "Epoch %d batch %d loss %.6f acc %.4f lr %.6g%s",
            epoch, idx, m["loss"], m["acc"], lr,
            " SKIPPED(non-finite)" if m["skipped"] else "",
        )

    def _summed(self, *values: float) -> List[float]:
        """``values`` summed over every rank (as they are without a
        process group)."""
        if not is_distributed():
            return list(values)
        out = all_reduce_sum(torch.tensor(values, dtype=torch.float64,
                                          device=self.trainer.device))
        return out.cpu().tolist()

    def _summary(self, epoch: int, lr: float, losses: list, accs: list,
                 n_batches: int, audio_seconds: float,
                 start: float) -> Dict[str, float]:
        elapsed = max(time.time() - start, 1e-9)
        summary = {
            "train_loss": float(np.mean(losses)) if losses else float("nan"),
            "train_acc": float(np.mean(accs)) if accs else float("nan"),
            "batches": n_batches,
            "audio_seconds_per_s": audio_seconds / elapsed,
        }
        self.log_metrics({"epoch": epoch, "lr": lr, **summary})
        return summary

    def train(self, state, dataset: Iterable[Dict], seed: int, lr: float,
              epoch: int) -> Tuple[object, Dict[str, float]]:
        losses, accs, audio_seconds = [], [], 0.0
        start = time.time()
        n_batches = 0
        for idx, batch in self._window(self._iterate(dataset)):
            audio_seconds += float(np.asarray(batch["wave_lengths"]).sum()) \
                / 16000.0
            state, metrics = self.trainer.train_step(state, batch, seed, lr)
            n_batches += 1
            if idx % self.log_interval == 0:
                self._log_batch(epoch, idx, metrics, lr, losses, accs)
        self._sync()
        audio_seconds, = self._summed(audio_seconds)
        return state, self._summary(epoch, lr, losses, accs, n_batches,
                                    audio_seconds, start)

    def train_resident(self, state, corpus, seed: int, lr: float,
                       epoch: int,
                       batch_size: int) -> Tuple[object, Dict[str, float]]:
        """One epoch over a staged ``ResidentCorpus``: the epoch's
        (steps, B) row indices are its one upload, and every step
        gathers its rows on the device and runs ``Trainer.train_step``.
        The order is ``Random(epoch)``, the host pipeline's
        ``DataList`` order; the tail that fills no batch is dropped.
        Under data parallelism ``batch_size`` is the global batch, as in
        the JAX package's resident mode (its host-fed batch size is per
        process): the index rows run over the global corpus and rank r
        trains on columns ``[r B / W, (r + 1) B / W)`` of each.

        Metrics are read from the device every ``log_interval`` steps
        (when the epoch has that many) and once at its end."""
        epoch_idx = corpus.epoch_index(epoch, batch_size)
        steps = epoch_idx.shape[0]
        idx_dev = torch.from_numpy(rank_columns(epoch_idx)).to(
            self.trainer.device)
        audio_seconds = float(corpus.host_wave_lengths[epoch_idx].sum()) \
            / corpus.sample_rate
        losses, accs = [], []
        log_batches = self.log_interval <= steps
        start = time.time()
        for idx, rows in self._window(idx_dev):
            state, metrics = self.trainer.train_step(
                state, gather_rows(corpus.arrays, rows), seed, lr)
            if log_batches and idx % self.log_interval == 0:
                self._log_batch(epoch, idx, metrics, lr, losses, accs)
        if not losses:
            self._log_batch(epoch, steps - 1, metrics, lr, losses, accs)
        self._sync()
        return state, self._summary(epoch, lr, losses, accs, steps,
                                    audio_seconds, start)

    def cv(self, state, dataset: Iterable[Dict], epoch: int = 0,
           decode_acc: bool = False) -> Dict[str, float]:
        """Validation: exact per-utterance accumulation.

        ``decode_acc`` also runs the host prefix-beam decode accuracy of
        a CTC model (``acc_utterance``, slow) and reports the mean over
        batches as ``cv_decode_acc``."""
        total_loss, total_correct, total_utts = 0.0, 0.0, 0
        decode_hits = []
        decode_acc = decode_acc and process_count() == 1
        step = self.trainer.cv_step_full if decode_acc else \
            self.trainer.cv_step
        for batch in self._iterate(dataset):
            out = step(state, batch)
            total_loss += float(out["loss_sum"])
            total_correct += float(out["correct_sum"])
            total_utts += int(out["count"])
            if "log_probs" in out:
                decode_hits.append(acc_utterance(
                    torch.exp(out["log_probs"]).cpu().numpy(),
                    np.asarray(batch["target"]),
                    out["feat_lengths"].cpu().numpy(),
                    np.asarray(batch["target_lengths"])))
        extra = {}
        if decode_hits:
            extra["cv_decode_acc"] = float(np.mean(decode_hits))
        return self._cv_result(epoch, total_loss, total_correct,
                               total_utts, extra)

    def _cv_result(self, epoch: int, total_loss: float, total_correct: float,
                   total_utts: int, extra: Dict) -> Dict[str, float]:
        total_loss, total_correct, total_utts = self._summed(
            total_loss, total_correct, total_utts)
        total_utts = int(total_utts)
        result = {
            "cv_loss": total_loss / max(total_utts, 1),
            "cv_acc": total_correct / max(total_utts, 1),
            "utts": total_utts,
            **extra,
        }
        logging.info("Epoch %d CV loss %.6f acc %.4f (%d utts)", epoch,
                     result["cv_loss"], result["cv_acc"], total_utts)
        return result

    def cv_resident(self, state, corpus, batch_size: int,
                    epoch: int = 0) -> Dict[str, float]:
        """Validation over a staged corpus in list order, with ``cv``'s
        accumulation: the last batch is padded with row 0 and those
        slots' validity zeroed, so every row counts once.  The batches'
        sums stay on the device until the last batch.  Under data
        parallelism each rank takes its columns of each batch, as
        ``train_resident`` does."""
        idx, ok = corpus.cv_index(batch_size)
        idx_dev = torch.from_numpy(rank_columns(idx)).to(self.trainer.device)
        ok_dev = torch.from_numpy(rank_columns(ok)).to(self.trainer.device)
        outs = [self.trainer.cv_step(state, gather_rows(corpus.arrays, i, o))
                for i, o in zip(idx_dev, ok_dev)]
        sums = torch.stack([torch.stack([o["loss_sum"], o["correct_sum"],
                                         o["count"]]) for o in outs])
        total_loss, total_correct, total_utts = 0.0, 0.0, 0
        for loss_sum, correct_sum, count in sums.cpu().tolist():
            total_loss += loss_sum
            total_correct += correct_sum
            total_utts += int(count)
        return self._cv_result(epoch, total_loss, total_correct, total_utts,
                               {})

    def test(self, state, dataset: Iterable[Dict],
             epoch: int = 0) -> Dict[str, float]:
        """Test-set evaluation, the same accumulation as cv."""
        return self.cv(state, dataset, epoch)


def rank_columns(rows: np.ndarray, rank: Optional[int] = None,
                 world: Optional[int] = None) -> np.ndarray:
    """Rank ``rank``'s columns of a (steps, B) matrix of the global batch
    (default: this process of its group): ``[r B / W, (r + 1) B / W)``;
    all of it without a process group."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    b = rows.shape[1]
    if b % world:
        raise ValueError(f"the global batch of {b} rows does not split "
                         f"over {world} processes")
    part = b // world
    return np.ascontiguousarray(rows[:, rank * part:(rank + 1) * part])
