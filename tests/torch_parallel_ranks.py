"""Rank bodies for tests/test_torch_parallel.py.

Each function runs in one process of a gloo group on the CPU that
``wekws_tpu_torch.parallel.launch.run_local`` started, and returns
numpy arrays and numbers.  This module imports the port only, so the
spawned ranks start without JAX.
"""

import numpy as np
import torch

from wekws_tpu_torch.data import DeviceFeaturePipeline
from wekws_tpu_torch.data.resident import stage_arrays
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.parallel.mesh import (
    collective_backend,
    distributed_close,
    free_port,
    join_group,
    process_count,
    process_index,
)
from wekws_tpu_torch.train import Executor, Trainer
from wekws_tpu_torch.train.steps import step_generator

LR = 1e-3
SEED = 1
RAGGED_SPLIT = 5  # rank 0's rows of the 8 in ragged_step


def port_trainer(conf, state, dataset_conf):
    """The port's Trainer on the CPU holding ``state`` (a numpy
    state_dict)."""
    model = init_model(conf)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()})
    return Trainer(model, DeviceFeaturePipeline.from_conf(dataset_conf),
                   DeviceFeaturePipeline.from_conf(dataset_conf,
                                                   training=False),
                   "max_pooling", grad_clip=5.0, min_duration=5,
                   device="cpu")


def numpy_state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def local_rows(batch, rank, world):
    """Rank ``rank``'s rows of the global batch."""
    part = len(batch["waves"]) // world
    return {k: v[rank * part:(rank + 1) * part] for k, v in batch.items()}


def three_steps(conf, state, dataset_conf, batch):
    """Three train steps on this rank's rows: per step (loss, grad
    norm, state), and the summed step-0 gradients."""
    trainer = port_trainer(conf, state, dataset_conf)
    st = trainer.init_state()
    local = local_rows(batch, process_index(), process_count())
    steps, grads0 = [], None
    for _ in range(3):
        st, m = trainer.train_step(st, local, SEED, LR)
        if grads0 is None:
            grads0 = {n: p.grad.numpy().copy()
                      for n, p in st.model.named_parameters()}
        steps.append((float(m["loss"]), float(m["grad_norm"]),
                      float(m["skipped"]), numpy_state(st.model)))
    return steps, grads0


def draws(aug_confs, batch):
    """This rank's step-0 features of the global batch's waves through
    each pipeline conf, drawn from the trainer's step generator."""
    waves = torch.from_numpy(batch["waves"])
    lengths = torch.from_numpy(batch["wave_lengths"]).long()
    out = []
    for conf in aug_confs:
        gen = step_generator(SEED, 0, "cpu", process_index())
        feats, _ = DeviceFeaturePipeline.from_conf(conf)(
            waves, lengths, generator=gen)
        out.append(feats.numpy())
    return out


def ragged_step(conf, state, dataset_conf, batch, split):
    """One train step, rank 0 on rows ``[0, split)`` of ``batch`` and
    rank 1 on the rest (shards of different sizes): (loss, state)."""
    rows = slice(0, split) if process_index() == 0 else slice(split, None)
    trainer = port_trainer(conf, state, dataset_conf)
    st, m = trainer.train_step(trainer.init_state(),
                               {k: v[rows] for k, v in batch.items()},
                               SEED, LR)
    return float(m["loss"]), numpy_state(st.model)


def one_rank_steps(confs, state, dataset_conf, batch):
    """Leave the two-rank group; rank 0 alone joins a one-rank group
    (``join_group``, as every group is made) and takes one step on the
    whole batch for each conf: (its backend, {conf: (loss, state)})."""
    rank = process_index()
    distributed_close()
    if rank:
        return None
    join_group(f"127.0.0.1:{free_port()}", 1, 0, "cpu")
    try:
        out = {}
        for name, conf in confs.items():
            trainer = port_trainer(conf, state, dataset_conf)
            st, m = trainer.train_step(trainer.init_state(), batch, SEED, LR)
            out[name] = (float(m["loss"]), numpy_state(st.model))
        return collective_backend(), out
    finally:
        distributed_close()


def resident_checks(conf, state, dataset_conf, arrays, batch_size,
                    cv_batches):
    """On the global corpus staged on every rank: ``cv_resident`` and
    the host-fed ``cv`` over this rank's share of ``cv_batches`` on the
    initial weights, then one ``train_resident`` epoch."""
    trainer = port_trainer(conf, state, dataset_conf)
    ex = Executor(trainer, log_interval=100)
    corpus = stage_arrays(arrays, device="cpu")
    st = trainer.init_state()
    world, rank = process_count(), process_index()
    out = {"cv_resident": ex.cv_resident(st, corpus, batch_size),
           "cv": ex.cv(st, cv_batches[rank::world])}
    st, out["summary"] = ex.train_resident(st, corpus, SEED, LR, 0,
                                           batch_size)
    out["state"] = numpy_state(st.model)
    return out


def all_checks(rank, confs, state, dataset_conf, batch, aug_confs, arrays,
               batch_size, cv_batches, ghost=None):
    """In the two-rank group: for each conf three steps on this rank's
    half of ``batch``, and one step on shards of 5 and 3 rows; the draws
    of each augmentation conf; the resident and cv checks (the first
    conf); ``ghost`` (a ghost-BN conf and its state), one step on the
    shards of 5 and 3 rows; then, rank 0 alone, a step in a one-rank
    group for each conf."""
    torch.set_num_threads(1)
    out = {name: dict(zip(("steps", "grads0"),
                          three_steps(conf, state, dataset_conf, batch)))
           for name, conf in confs.items()}
    for name, conf in confs.items():
        out[name]["ragged"] = ragged_step(conf, state, dataset_conf, batch,
                                          RAGGED_SPLIT)
    if ghost is not None:
        out["ghost"] = ragged_step(*ghost, dataset_conf, batch, RAGGED_SPLIT)
    out["draws"] = draws(aug_confs, batch)
    out["resident"] = resident_checks(next(iter(confs.values())), state,
                                      dataset_conf, arrays, batch_size,
                                      cv_batches)
    out["one_rank"] = one_rank_steps(confs, state, dataset_conf, batch)
    return out
