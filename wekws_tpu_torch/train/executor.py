"""Epoch-level training loop.

Port of wekws_tpu/train/executor.py: a one-epoch train loop and a cv
loop with loss/acc accumulation over the host pipeline's batches.  A
``DataLoader`` iterates itself (worker processes; the caller sets its
epoch); any other iterable of numpy batch dicts (a ``Dataset``, a list)
is run ahead of the device by the thread ``Prefetcher``.  cv counts
exactly: fill rows (``valid`` 0) and non-finite losses are left out.
One card: no mesh, no padding to a device multiple.  Device-resident
epochs (ROADMAP queue A, item 10) are not ported yet.
"""

import json
import logging
import os
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from wekws_tpu_torch.data.loader import DataLoader
from wekws_tpu_torch.data.prefetch import Prefetcher
from wekws_tpu_torch.decode.accuracy import acc_utterance

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

    def train(self, state, dataset: Iterable[Dict], seed: int, lr: float,
              epoch: int) -> Tuple[object, Dict[str, float]]:
        losses, accs, audio_seconds = [], [], 0.0
        start = time.time()
        n_batches = 0
        prof = None
        for idx, batch in enumerate(self._iterate(dataset)):
            if self.profile_dir and not self._profiled \
                    and idx == PROFILE_STEPS[0]:
                prof = self._profiler()
                prof.start()
            audio_seconds += float(np.asarray(batch["wave_lengths"]).sum()) \
                / 16000.0
            state, metrics = self.trainer.train_step(state, batch, seed, lr)
            if prof is not None and idx == PROFILE_STEPS[1] - 1:
                self._stop_profile(prof)
                prof = None
            n_batches += 1
            if idx % self.log_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                losses.append(m["loss"])
                accs.append(m["acc"])
                logging.info(
                    "Epoch %d batch %d loss %.6f acc %.4f lr %.6g%s",
                    epoch, idx, m["loss"], m["acc"], lr,
                    " SKIPPED(non-finite)" if m["skipped"] else "",
                )
        if prof is not None:  # the epoch ended inside the window
            self._stop_profile(prof)
        self._sync()
        elapsed = max(time.time() - start, 1e-9)
        summary = {
            "train_loss": float(np.mean(losses)) if losses else float("nan"),
            "train_acc": float(np.mean(accs)) if accs else float("nan"),
            "batches": n_batches,
            "audio_seconds_per_s": audio_seconds / elapsed,
        }
        self.log_metrics({"epoch": epoch, "lr": lr, **summary})
        return state, summary

    def cv(self, state, dataset: Iterable[Dict], epoch: int = 0,
           decode_acc: bool = False) -> Dict[str, float]:
        """Validation: exact per-utterance accumulation.

        ``decode_acc`` also runs the host prefix-beam decode accuracy of
        a CTC model (``acc_utterance``, slow) and reports the mean over
        batches as ``cv_decode_acc``."""
        total_loss, total_correct, total_utts = 0.0, 0.0, 0
        decode_hits = []
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
        result = {
            "cv_loss": total_loss / max(total_utts, 1),
            "cv_acc": total_correct / max(total_utts, 1),
            "utts": total_utts,
        }
        if decode_hits:
            result["cv_decode_acc"] = float(np.mean(decode_hits))
        logging.info("Epoch %d CV loss %.6f acc %.4f (%d utts)", epoch,
                     result["cv_loss"], result["cv_acc"], total_utts)
        return result

    def test(self, state, dataset: Iterable[Dict],
             epoch: int = 0) -> Dict[str, float]:
        """Test-set evaluation, the same accumulation as cv."""
        return self.cv(state, dataset, epoch)
