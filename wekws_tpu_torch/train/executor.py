"""Epoch-level training loop.

Port of wekws_tpu/train/executor.py: a one-epoch train loop and a cv
loop with loss/acc accumulation (non-finite cv losses excluded) over
any iterable of numpy batch dicts.  The host DataLoader and its
prefetcher (ROADMAP queue A, item 9) and device-resident epochs (item
10) are not ported yet.
"""

import json
import logging
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch


class Executor:
    def __init__(self, trainer, log_interval: int = 10,
                 metrics_path: Optional[str] = None):
        """``metrics_path`` appends per-epoch JSONL records."""
        self.trainer = trainer
        self.log_interval = log_interval
        self.metrics_path = metrics_path

    def log_metrics(self, record: Dict) -> None:
        if self.metrics_path:
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def _sync(self) -> None:
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)

    def train(self, state, dataset: Iterable[Dict], seed: int, lr: float,
              epoch: int) -> Tuple[object, Dict[str, float]]:
        losses, accs, audio_seconds = [], [], 0.0
        start = time.time()
        n_batches = 0
        for idx, batch in enumerate(dataset):
            audio_seconds += float(np.asarray(batch["wave_lengths"]).sum()) \
                / 16000.0
            state, metrics = self.trainer.train_step(state, batch, seed, lr)
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

    def cv(self, state, dataset: Iterable[Dict],
           epoch: int = 0) -> Dict[str, float]:
        """Validation: exact per-utterance accumulation."""
        total_loss, total_correct, total_utts = 0.0, 0.0, 0
        for batch in dataset:
            out = self.trainer.cv_step(state, batch)
            total_loss += float(out["loss_sum"])
            total_correct += float(out["correct_sum"])
            total_utts += int(out["count"])
        result = {
            "cv_loss": total_loss / max(total_utts, 1),
            "cv_acc": total_correct / max(total_utts, 1),
            "utts": total_utts,
        }
        logging.info("Epoch %d CV loss %.6f acc %.4f (%d utts)", epoch,
                     result["cv_loss"], result["cv_acc"], total_utts)
        return result

    def test(self, state, dataset: Iterable[Dict],
             epoch: int = 0) -> Dict[str, float]:
        """Test-set evaluation, the same accumulation as cv."""
        return self.cv(state, dataset, epoch)
