"""Resident training: the per-step body of ``Executor.train_resident``.

Set-up makes the corpus on the card from the seed (``rows`` utterances
of ``seconds_per_row``, int16, with their keyword labels) as a
``ResidentCorpus``, builds the port's ``Trainer`` around the model with
the harness's weights, and drives that trainer through its first
``check_steps`` steps, the same call as the window's, on rows that all
differ, then ``warm_steps`` more.  The window repeats the body
(``gather_rows`` of the step's rows, ``Trainer.train_step``), reads the
metrics from the device every ``log_interval`` steps as the loop does,
and ends at the first read past ``--seconds``; the rate is all audio
trained over the window's wall time, synchronised at both ends.

Afterwards the reference follows the first steps from the same weights,
rows and draws (``kwsbench.correct`` says what is compared).  The
global generator, which dropout draws from, is seeded before the first
step on both sides.
"""

import time

import numpy as np
import torch

from kwsbench import correct, inputs
from kwsbench.drivers import common
from kwsbench.reference import models as ref_models


def train_conf(config: dict, conf: dict) -> dict:
    """What the reference's steps need of the configuration (which
    draws no spec_aug masks)."""
    if config["dataset_conf"].get("spec_aug", False):
        raise ValueError("the reference draws no spec_aug masks")
    return {"grad_clip": config["training_config"]["grad_clip"],
            "lr": config["optim_conf"]["lr"],
            "min_duration": config["min_duration"],
            "dropout": conf["backbone"].get("dropout", 0.1)}


def corpus_arrays(cell) -> dict:
    tr, dev = cell.traffic, cell.device
    rows = tr["rows"]
    waves = inputs.waves(rows, tr, cell.seed, dev)
    return {"waves": waves,
            "wave_lengths": torch.full((rows,), waves.shape[1],
                                       dtype=torch.int32, device=dev),
            "target": inputs.labels(rows, cell.config["num_keywords"],
                                    cell.seed, dev),
            "valid": torch.ones((rows,), dtype=torch.float32, device=dev)}


def index_rows(cell, steps: int) -> torch.Tensor:
    """(steps, B) rows: epochs 0, 1, ... in the resident order."""
    rows, b = cell.traffic["rows"], cell.traffic["batch_size"]
    per = rows // b
    epochs = -(-steps // per)
    idx = np.concatenate([common.epoch_rows(rows, b, e)
                          for e in range(epochs)])[:steps]
    return torch.from_numpy(idx).to(cell.device)


def reference_batches(arrays: dict, idx: torch.Tensor, n: int) -> list:
    return [{k: torch.index_select(v, 0, idx[i]) for k, v in arrays.items()}
            for i in range(n)]


def dropout_seed(seed: int) -> int:
    return inputs.stream_seed(seed, "dropout")


def run(cell) -> None:
    from wekws_tpu_torch.data.device_pipeline import DeviceFeaturePipeline
    from wekws_tpu_torch.data.resident import ResidentCorpus, gather_rows
    from wekws_tpu_torch.train.steps import Trainer

    config, tr, dev, seed = cell.config, cell.traffic, cell.device, cell.seed
    dc = config["dataset_conf"]
    pipeline = DeviceFeaturePipeline.from_conf(dc, training=True)
    cv_pipeline = DeviceFeaturePipeline.from_conf(dc, training=False)
    conf = common.model_conf(config, pipeline.output_dim)
    model, weights = common.port_model(conf, seed, dev)
    tc, oc = config["training_config"], config["optim_conf"]
    lr = oc["lr"]
    trainer = Trainer(model, pipeline, cv_pipeline, "max_pooling",
                      grad_clip=tc["grad_clip"],
                      weight_decay=oc.get("weight_decay", 0.0),
                      min_duration=config["min_duration"], device=dev)
    state = trainer.init_state()
    arrays = corpus_arrays(cell)
    n, sr = tr["rows"], tr["sample_rate"]
    s = arrays["waves"].shape[1]
    corpus = ResidentCorpus(arrays=arrays, n=n, audio_seconds=n * s / sr,
                            host_wave_lengths=np.full((n,), s, np.int32),
                            sample_rate=sr)
    b = tr["batch_size"]
    check, warm = tr["check_steps"], tr["warm_steps"]
    max_steps = check + warm + int(cell.seconds * tr["max_steps_per_s"]) + 1
    idx = index_rows(cell, max_steps)
    spans = cell.spans

    # the first steps: the window's trainer, checked against the reference
    torch.manual_seed(dropout_seed(seed))
    losses, mu0 = [], None
    for i in range(check + warm):
        batch = gather_rows(corpus.arrays, idx[i])
        state, metrics = trainer.train_step(state, batch, seed, lr)
        if i < check:
            losses.append(metrics["loss"])
        if i == 0:
            mu0 = state.optimizer.mu.detach().clone()
        if i == check - 1:
            after = {k: p.detach().clone()
                     for k, p in model.named_parameters()}
    prog = {"loss": [float(x) for x in losses],
            "change": {k: after[k] - weights[k] for k in after}}
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    b1 = state.optimizer.b1
    grad0, at = {}, 0
    for k in names:
        numel = weights[k].numel()
        grad0[k] = (mu0[at:at + numel] / (1 - b1)).view(weights[k].shape)
        at += numel
    prog["grad0"] = grad0
    del mu0
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    cell.setup_done()

    # the window
    log = tr["log_interval"]
    traced = common.TracedPart(cell, tr["trace_from"], tr["trace_steps"])
    k, steps, bad = check + warm, 0, 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_start = time.perf_counter()
    while True:
        traced.before(steps)
        with spans("gather"):
            batch = gather_rows(corpus.arrays, idx[k % len(idx)])
        with spans("train_step"):
            state, metrics = trainer.train_step(state, batch, seed, lr)
        k += 1
        steps += 1
        if steps % log == 0:
            with spans("metrics_read"):
                m = {key: float(v) for key, v in metrics.items()}
            bad += int(not np.isfinite(m["loss"]) or m["skipped"] > 0)
            traced.after(steps)
            if time.perf_counter() - t_start >= cell.seconds \
                    and not traced.pending:
                break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t_start
    cell.e2e["train_audio_s_per_s"] = common.audio_rate(steps, b, s, sr, wall)
    cell.attempted, cell.failed = steps, bad
    cell.layer.update(trace=traced.reduced, units=traced.units,
                      thread_s=traced.thread_s, batch=b, samples=s,
                      conf=conf)
    if dev.type == "cuda":
        cell.memory_peak = torch.cuda.max_memory_allocated(dev)

    # the check, with the program's state freed
    batches = reference_batches(arrays, idx, check)
    del state, trainer, model, corpus, arrays, batch, metrics
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(cell, conf, weights, batches, "fp32")
    cell.numbers, cell.info = correct.train_numbers(prog, ref)


def reference_steps(cell, conf, weights, batches, precision: str,
                    half: bool = False) -> dict:
    """The reference's first steps at ``precision``; ``half`` leaves out
    the second half of each batch (a fault's reading)."""
    if half:
        batches = [{k: v[:v.shape[0] // 2] for k, v in bt.items()}
                   for bt in batches]
    feats, model = common.reference(conf, cell.config["dataset_conf"],
                                    cell.device, precision)
    out = ref_models.train_steps(model, feats, weights, batches, cell.seed,
                                 train_conf(cell.config, conf),
                                 dropout_seed(cell.seed))
    return {"loss": out["loss"], "grad0": out["grad0"],
            "change": {k: out["params"][k] - weights[k].float()
                       for k in out["params"]}}
