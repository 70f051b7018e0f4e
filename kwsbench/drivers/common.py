"""What a driver builds: the model's configuration, its weights, the
reference beside it, and the traced part of a window."""

import random
import time

import numpy as np
import torch

from kwsbench import inputs
from kwsbench.reference import frontend as ref_frontend
from kwsbench.reference import models as ref_models
from kwsbench.trace import Profile


def model_conf(config: dict, input_dim: int) -> dict:
    """The ``model`` group as ``bin/train`` resolves it (input and output
    sizes)."""
    return dict(config["model"], input_dim=input_dim,
                output_dim=config["num_keywords"])


def port_model(conf: dict, seed: int, device):
    """The port's model of ``conf`` (on the CPU) with the harness's
    weights drawn from ``seed`` on ``device``; returns (model, weights)."""
    from wekws_tpu_torch.models import init_model

    model = init_model(conf)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    weights = inputs.model_weights(shapes, seed, device)
    model.load_state_dict(weights, strict=False)
    return model, weights


def reference(conf: dict, dataset_conf: dict, device, precision: str):
    """(features, model) of the plain reference."""
    return (ref_frontend.Features(dataset_conf, device),
            ref_models.Model(conf, precision))


def audio_rate(units: int, batch: int, samples: int, sample_rate: int,
               wall_s: float) -> float:
    """Audio seconds a second: ``units`` batches of ``batch`` utterances
    of ``samples`` samples over ``wall_s``."""
    return units * batch * samples / sample_rate / wall_s


def epoch_rows(n: int, batch: int, epoch: int) -> np.ndarray:
    """(steps, B) row indices of an epoch: ``random.Random(epoch)`` over
    the rows, the tail that fills no batch dropped (the resident
    epochs' order)."""
    idx = list(range(n))
    random.Random(epoch).shuffle(idx)
    steps = n // batch
    return np.asarray(idx[:steps * batch], np.int32).reshape(steps, batch)


class TracedPart:
    """The profiler over units ``[start, start + count)`` of a window
    (training steps), opened and closed at unit boundaries; records
    the host thread's CPU time over it."""

    def __init__(self, cell, start: int, count: int):
        self.on = cell.trace
        self.start, self.stop = start, start + count
        self.prof = None
        self.span = None
        self.units = count
        self.thread_s = None

    def before(self, unit: int) -> None:
        if self.on and unit == self.start and self.prof is None:
            self.prof = Profile().__enter__()
            self.span = torch.profiler.record_function("kwsbench.window")
            self.span.__enter__()
            self._thread0 = time.thread_time()

    def after(self, unit_done: int) -> None:
        """``unit_done``: units finished, after a read that synchronised."""
        if self.prof is not None and self.span is not None \
                and unit_done >= self.stop:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.thread_s = time.thread_time() - self._thread0
            self.span.__exit__(None, None, None)
            self.span = None
            self.prof.__exit__(None, None, None)

    @property
    def pending(self) -> bool:
        """Whether the window must go on: the traced part not yet
        closed."""
        return self.on and (self.prof is None or self.span is not None)

    @property
    def reduced(self):
        return None if self.prof is None else self.prof.reduced
