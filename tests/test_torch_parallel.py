"""Data parallelism of the port (wekws_tpu_torch/parallel, A.13) on the
CPU: two ranks of a gloo group, spawned by ``parallel.launch.run_local``
(their bodies: tests/torch_parallel_ranks.py), each training on half of
one global batch, against the JAX package's ``Trainer`` on a 2-device
mesh with the whole batch, and against the port in one process; the
resident corpus and cv over two ranks; ``bin.train`` as two processes;
the bucket schedule's lockstep on a skewed list; the serving engines
split over two devices against the one-device engine and JAX's engine
on a 2-device mesh."""

import copy
import json
import os
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_parallel_ranks as ranks
from wekws_tpu.data.device_pipeline import (
    DeviceFeaturePipeline as JaxPipeline,
)
from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.parallel import make_mesh, shard_batch
from wekws_tpu.parallel.mesh import pad_batch_to_multiple as jax_pad
from wekws_tpu.runtime import BatchKeywordSpotter as JaxBatchKeywordSpotter
from wekws_tpu.train import Trainer as JaxTrainer
from wekws_tpu.train import save_checkpoint as jax_save_checkpoint
from wekws_tpu_torch.data import DeviceFeaturePipeline, init_dataset
from wekws_tpu_torch.data.resident import stage_arrays
from wekws_tpu_torch.parallel import distributed_init, pad_batch_to_multiple
from wekws_tpu_torch.parallel.launch import run_local
from wekws_tpu_torch.parallel.mesh import free_port, mesh_devices
from wekws_tpu_torch.runtime import BatchKeywordSpotter, BatchMaxPoolSpotter
from wekws_tpu_torch.tools.from_jax import model_from_jax
from wekws_tpu_torch.train import Executor
from wekws_tpu_torch.train.steps import step_generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "examples", "synthetic")
DATA = os.path.join(RECIPE, "data")
LR = ranks.LR
DATASET_CONF = {
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 40, "frame_shift": 10,
                   "frame_length": 25, "dither": 0.0},
}
# each draws from the step generator alone: dither, then spec_aug
AUG_CONFS = (
    {"feats_type": "fbank",
     "fbank_conf": dict(DATASET_CONF["fbank_conf"], dither=1.0,
                        dither_mode="wave")},
    dict(DATASET_CONF, spec_aug=True, spec_aug_conf={
        "num_t_mask": 2, "num_f_mask": 2, "max_t": 20, "max_f": 10}),
)
GRAD_TOL = 1e-4  # of max(1, max |grad|): tests/test_torch_training.py's
# Step 0's parameters are held at HELD_TOL wherever the reference
# gradient's sign is settled: Adam's first update is lr * sign(g), so
# there a wrong gradient moves a parameter 2 * lr away, where the
# bound of _bound() cannot see it.  Against one process the gradients
# agree within GRAD_TOL of their scale, so |grad| above that settles
# the sign; JAX's jitted step differs from eager gradients by up to
# 3e-3 of max |grad| (tests/test_torch_training.py), so against JAX
# the floor is HELD_FLOOR_JAX of the tensor's max(1, max |grad|).
HELD_TOL, HELD_FLOOR_JAX = 1e-5, 1e-2
RUN_TIMEOUT_S = 240.0


def _batch(b=8, n=8000):
    """Keyword rows carry a 500 Hz tone in noise, fillers noise; rank 1's
    half (rows b/2..) is 6 times louder, so its BN statistics are far
    from rank 0's and from the whole batch's."""
    rng = np.random.default_rng(0)
    t = np.arange(n) / 16000.0
    waves = (rng.standard_normal((b, n)) * 300).astype(np.float32)
    waves[::2] += (4000 * np.sin(2 * np.pi * 500 * t)).astype(np.float32)
    waves[b // 2:] *= 6.0
    lengths = np.full((b,), n, np.int32)
    lengths[-1] = n - 1600  # one padded row
    waves[-1, lengths[-1]:] = 0.0
    return {"waves": waves, "wave_lengths": lengths,
            "target": (np.arange(b) % 2 - 1).astype(np.int32),
            "target_lengths": np.ones((b,), np.int32)}


def _model_conf(batch, fused):
    """tests/test_torch_training.py's flagship-shaped MDTC (16 channels,
    2 x 2 blocks, kernel 3), its CMVN from the batch."""
    feats, _ = JaxPipeline.from_conf(DATASET_CONF, training=False)(
        jnp.asarray(batch["waves"]), jnp.asarray(batch["wave_lengths"]))
    return {
        "input_dim": 40, "output_dim": 1, "hidden_dim": 16,
        "preprocessing": {"type": "linear"},
        "backbone": {"type": "mdtc", "num_stack": 2, "stack_size": 2,
                     "kernel_size": 3, "hidden_dim": 16, "causal": True,
                     "fused_train": fused},
        "cmvn": {"mean": np.asarray(feats.mean(axis=(0, 1))).tolist(),
                 "istd": np.asarray(
                     1.0 / (feats.std(axis=(0, 1)) + 1e-6)).tolist(),
                 "norm_var": True},
    }


def _numpy_state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_run():
    """JAX's Trainer (the unfused exact-BN model: the fused route's
    parity with it is pinned by tests/test_torch_fused_train.py) on
    ``make_mesh(2)`` with the whole batch: three steps (loss, params
    and BN statistics after each)."""
    batch = _batch()
    conf = _model_conf(batch, False)
    model = jax_init_model(conf)
    trainer = JaxTrainer(model, JaxPipeline.from_conf(DATASET_CONF, True),
                         JaxPipeline.from_conf(DATASET_CONF, False),
                         "max_pooling", learning_rate=LR, grad_clip=5.0,
                         min_duration=5)
    mesh = make_mesh(2)
    state = trainer.init_state(jax.random.PRNGKey(0), batch, mesh)
    init = jax.device_get((state.params, state.batch_stats))
    db = shard_batch(batch, mesh)
    steps = []
    for _ in range(3):
        state, metrics = trainer.train_step(state, db,
                                            jax.random.PRNGKey(1), LR)
        steps.append((float(metrics["loss"]), jax.device_get(
            (state.params, state.batch_stats))))
    port = _numpy_state(model_from_jax(*init, conf))
    return {"batch": batch, "conf": conf, "state": port, "steps": steps}


def _resident_arrays(n=16, s=6000):
    """int16 rows of a tone per class in noise, the second half louder,
    the last row shorter."""
    rng = np.random.default_rng(4)
    t = np.arange(s) / 16000.0
    waves = np.zeros((n, s), np.int16)
    for i in range(n):
        w = 0.02 * rng.standard_normal(s)
        if i % 2 == 0:
            w += 0.2 * np.sin(2 * np.pi * 500 * t)
        w *= 4.0 if i >= n // 2 else 1.0
        waves[i] = np.clip(np.rint(w * 32768.0), -32768, 32767)
    lengths = np.full((n,), s, np.int32)
    lengths[-1] = s - 1000
    waves[-1, lengths[-1]:] = 0
    return {"waves": waves, "wave_lengths": lengths,
            "target": (np.arange(n) % 2 - 1).astype(np.int32),
            "target_lengths": np.ones((n,), np.int32)}


ROUTES = ("fused", "unfused")
GHOST_GROUPS = 2  # of 4 rows: the 5/3 shards split the second group


@pytest.fixture(scope="module")
def jax_ghost():
    """JAX's Trainer with ``ghost_bn: GHOST_GROUPS`` (and
    ``fused_train``, which ghost BN bypasses) on ``make_mesh(2)``: one
    step on the whole batch, sharded (loss, params and BN statistics),
    and its initial state for the port."""
    batch = _batch()
    conf = _model_conf(batch, True)
    conf["backbone"] = dict(conf["backbone"], ghost_bn=GHOST_GROUPS)
    model = jax_init_model(conf)
    trainer = JaxTrainer(model, JaxPipeline.from_conf(DATASET_CONF, True),
                         JaxPipeline.from_conf(DATASET_CONF, False),
                         "max_pooling", learning_rate=LR, grad_clip=5.0,
                         min_duration=5)
    mesh = make_mesh(2)
    state = trainer.init_state(jax.random.PRNGKey(0), batch, mesh)
    init = jax.device_get((state.params, state.batch_stats))
    state, metrics = trainer.train_step(state, shard_batch(batch, mesh),
                                        jax.random.PRNGKey(1), LR)
    return {"conf": conf, "state": _numpy_state(model_from_jax(*init, conf)),
            "loss": float(metrics["loss"]),
            "after": jax.device_get((state.params, state.batch_stats))}


@pytest.fixture(scope="module")
def two_ranks(jax_run, jax_ghost):
    """One spawn of two gloo ranks that run every rank-side check
    (tests/torch_parallel_ranks.all_checks) for both routes; the inputs
    beside the ranks' results."""
    batch = jax_run["batch"]
    confs = {r: _model_conf(batch, r == "fused") for r in ROUTES}
    arrays = _resident_arrays()
    cv_batches = [ranks.local_rows(arrays, i, 4) for i in range(4)]
    outs = run_local(ranks.all_checks, 2, (
        confs, jax_run["state"], DATASET_CONF, batch, AUG_CONFS, arrays, 8,
        cv_batches, (jax_ghost["conf"], jax_ghost["state"])),
        timeout_s=RUN_TIMEOUT_S)
    return {"confs": confs, "arrays": arrays, "cv_batches": cv_batches,
            "outs": outs}


def _bound(name, i):
    """test_three_steps_match_jax's bound on a tensor after step i:
    parameters 2 * lr * steps + 1e-5 (Adam's first update is about lr *
    sign(g), and a gradient near zero can take the other sign), BN
    running statistics 1e-4 after the first step, then the parameters'
    bound plus 1e-4."""
    tol = 2 * LR * (i + 1) + 1e-5
    if "running" in name:
        tol = 1e-4 if i == 0 else tol + 1e-4
    return tol


def _state_errs(got, want):
    """{name: max abs error} over the float tensors of two state_dicts."""
    return {k: float(np.abs(got[k].astype(np.float64) - want[k]).max())
            for k in want if not k.endswith("num_batches_tracked")}


def _one_process_step(conf, state, batch):
    """The port's plain Trainer step in this process (no group): its
    loss, state and gradients."""
    trainer = ranks.port_trainer(conf, state, DATASET_CONF)
    st, m = trainer.train_step(trainer.init_state(), batch, ranks.SEED, LR)
    grads = {n: p.grad.numpy().copy()
             for n, p in st.model.named_parameters()}
    return float(m["loss"]), _numpy_state(st.model), grads


@pytest.fixture(scope="module")
def one_process(jax_run, two_ranks):
    """``_one_process_step`` on the whole batch for each route."""
    return {r: _one_process_step(two_ranks["confs"][r], jax_run["state"],
                                 jax_run["batch"]) for r in ROUTES}


def _held_errs(got, want, grads, floor):
    """Step 0's parameters at the coordinates whose reference |grad|
    exceeds ``floor`` of its tensor's max(1, max |grad|): (how many,
    the largest abs error)."""
    held, err = 0, 0.0
    for name, g in grads.items():
        mask = np.abs(g) > floor * max(float(np.abs(g).max()), 1.0)
        held += int(mask.sum())
        if mask.any():
            err = max(err, float(np.abs(got[name].astype(np.float64)
                                        - want[name])[mask].max()))
    return held, err


@pytest.mark.parametrize("route", ROUTES)
def test_two_ranks_match_jax(jax_run, two_ranks, one_process, route):
    """Two ranks, each on its half of the global batch, against JAX's
    Trainer on a 2-device mesh with the whole batch.  Three steps:
    losses 1e-4 rel, every parameter and BN running statistic within
    test_three_steps_match_jax's bounds; both ranks bit for bit alike
    (loss, gradient norm, every parameter and buffer).  Step 0's
    parameters where the gradient's sign is settled within HELD_TOL of
    JAX's and of one process's."""
    outs = [o[route] for o in two_ranks["outs"]]
    for (l0, n0, s0, st0), (l1, n1, s1, st1) in zip(outs[0]["steps"],
                                                    outs[1]["steps"]):
        assert (l0, n0, s0) == (l1, n1, s1)
        for name in st0:
            np.testing.assert_array_equal(st0[name], st1[name], name)
    for i, ((loss, _, skipped, got), (want_loss, jstate)) in enumerate(
            zip(outs[0]["steps"], jax_run["steps"])):
        assert skipped == 0.0
        np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
        want = _numpy_state(model_from_jax(*jstate, jax_run["conf"]))
        for name, err in _state_errs(got, want).items():
            assert err <= _bound(name, i), f"step {i}: {name} {err}"
        assert got["backbone.preprocessor.bn1.num_batches_tracked"] == i + 1
    _, one_state, grads = one_process[route]
    got = outs[0]["steps"][0][3]
    jax0 = _numpy_state(model_from_jax(*jax_run["steps"][0][1],
                                       jax_run["conf"]))
    for want, floor in ((jax0, HELD_FLOOR_JAX), (one_state, GRAD_TOL)):
        held, err = _held_errs(got, want, grads, floor)
        assert held > 0.3 * sum(g.size for g in grads.values()), held
        assert err <= HELD_TOL, (floor, held, err)


@pytest.mark.parametrize("route", ROUTES)
def test_two_ranks_gradients_and_faults(jax_run, two_ranks, one_process,
                                        route):
    """The ranks' summed step-0 gradients against one process's on the
    whole batch (tests/test_torch_training.py pins that against JAX):
    within 1e-4 of max(1, max |grad|).  The tests see the faults: one
    process on rank 0's half (what per-rank BN computes) leaves the BN
    running statistics more than 10x their bound off JAX's global step,
    and the BN scale and bias gradients counted twice would be off by
    more than 10x the gradient bound."""
    conf = two_ranks["confs"][route]
    batch, state = jax_run["batch"], jax_run["state"]
    want_grads = one_process[route][2]
    got_grads = two_ranks["outs"][0][route]["grads0"]
    assert set(got_grads) == set(want_grads)
    twice = []  # BN scale and bias gradients counted twice: 2 g for g
    for name, g in want_grads.items():
        scale = max(float(np.abs(g).max()), 1.0)
        assert np.abs(got_grads[name] - g).max() <= GRAD_TOL * scale, name
        if ".bn" in name:
            twice.append(np.abs(2 * got_grads[name] - g).max() / scale)
    assert len(twice) == 2 * 3 * 5  # scale and bias of 3 BNs in 5 blocks
    assert max(twice) > 10 * GRAD_TOL, twice
    _, half, _ = _one_process_step(conf, state,
                                   ranks.local_rows(batch, 0, 2))
    want = _numpy_state(model_from_jax(*jax_run["steps"][0][1],
                                       jax_run["conf"]))
    stats_err = max(err for name, err in _state_errs(half, want).items()
                    if "running" in name)
    assert stats_err > 10 * _bound("running", 0), stats_err


@pytest.mark.parametrize("route", ROUTES)
def test_one_rank_group_is_the_plain_step(two_ranks, one_process, route):
    """A one-rank group made by ``join_group`` (gloo on the CPU; every
    collective a copy) takes the plain Trainer step bit for bit: loss,
    parameters and BN buffers."""
    loss, plain, _ = one_process[route]
    backend, steps = two_ranks["outs"][0]["one_rank"]
    one_loss, one_state = steps[route]
    assert backend == "gloo"
    assert one_loss == loss and two_ranks["outs"][1]["one_rank"] is None
    for name in plain:
        np.testing.assert_array_equal(one_state[name], plain[name], name)


@pytest.mark.parametrize("route", ROUTES)
def test_ragged_shards_take_the_global_step(jax_run, two_ranks, one_process,
                                            route):
    """Shards of different sizes (rank 0 rows 0-4, rank 1 rows 5-7) take
    the global batch's step: the ranks bit for bit alike; the loss 1e-5
    rel and the BN running statistics 1e-6 from one process on all 8
    rows, and within test_three_steps_match_jax's bounds of JAX's step
    on a 2-device mesh; step 0's parameters where the gradient's sign
    is settled within HELD_TOL of both.  Every BatchNorm (the fused
    passes' too) must count the frames of both shards."""
    (l0, s0), (l1, s1) = (o[route]["ragged"] for o in two_ranks["outs"])
    assert l0 == l1
    for name in s0:
        np.testing.assert_array_equal(s0[name], s1[name], name)
    loss, one_state, grads = one_process[route]
    np.testing.assert_allclose(l0, loss, rtol=1e-5)
    jax0 = _numpy_state(model_from_jax(*jax_run["steps"][0][1],
                                       jax_run["conf"]))
    for name, err in _state_errs(s0, one_state).items():
        if "running" in name:
            assert err <= 1e-6, (name, err)
    for name, err in _state_errs(s0, jax0).items():
        assert err <= _bound(name, 0), (name, err)
    for want, floor in ((jax0, HELD_FLOOR_JAX), (one_state, GRAD_TOL)):
        held, err = _held_errs(s0, want, grads, floor)
        assert err <= HELD_TOL, (floor, held, err)


def test_ghost_bn_groups_span_the_ranks(jax_ghost, two_ranks):
    """``ghost_bn: 2`` over shards of 5 and 3 rows (the second group,
    rows 4-7, has one row on rank 0 and three on rank 1) takes the global
    batch's groups: the ranks bit for bit alike; the loss 1e-5 rel and
    the BN running statistics 1e-6 from one process on all 8 rows;
    against JAX's step on a 2-device mesh (its sharded batch) within
    test_three_steps_match_jax's bounds.  Without the group-sum
    all-reduce, rank 0's row 4 would be normalized alone."""
    (l0, s0), (l1, s1) = (o["ghost"] for o in two_ranks["outs"])
    assert l0 == l1
    for name in s0:
        np.testing.assert_array_equal(s0[name], s1[name], name)
    loss, one_state, _ = _one_process_step(jax_ghost["conf"],
                                           jax_ghost["state"],
                                           _batch())
    np.testing.assert_allclose(l0, loss, rtol=1e-5)
    for name, err in _state_errs(s0, one_state).items():
        if "running" in name:
            assert err <= 1e-6, (name, err)
    np.testing.assert_allclose(l0, jax_ghost["loss"], rtol=1e-4)
    want = _numpy_state(model_from_jax(*jax_ghost["after"],
                                       jax_ghost["conf"]))
    for name, err in _state_errs(s0, want).items():
        assert err <= _bound(name, 0), (name, err)


def test_draws_fold_the_rank(jax_run, two_ranks):
    """With dither, and with spec_aug, rank 0's step generator draws
    what one process's draws; rank 1's draws other numbers."""
    batch = jax_run["batch"]
    waves = torch.from_numpy(batch["waves"])
    lengths = torch.from_numpy(batch["wave_lengths"]).long()
    outs = two_ranks["outs"]
    for i, aug in enumerate(AUG_CONFS):
        gen = step_generator(ranks.SEED, 0, "cpu")
        alone, _ = DeviceFeaturePipeline.from_conf(aug)(
            waves, lengths, generator=gen)
        np.testing.assert_array_equal(outs[0]["draws"][i], alone.numpy())
        assert not np.array_equal(outs[1]["draws"][i], alone.numpy())


def test_resident_and_cv_match_one_process(jax_run, two_ranks):
    """Two ranks over one staged global corpus (fused route): a
    ``train_resident`` epoch of two global steps (B=8, each rank its 4
    columns) against one process on the same corpus and index rows,
    within the two-rank bounds, both ranks alike bit for bit; on the
    initial weights ``cv_resident`` and the host-fed ``cv`` (each rank
    half of the batches) give one process's loss, accuracy and count
    within 1e-6."""
    trainer = ranks.port_trainer(two_ranks["confs"]["fused"],
                                 jax_run["state"], DATASET_CONF)
    ex = Executor(trainer, log_interval=100)
    corpus = stage_arrays(two_ranks["arrays"], device="cpu")
    st = trainer.init_state()
    cvs = {"cv_resident": ex.cv_resident(st, corpus, 8),
           "cv": ex.cv(st, two_ranks["cv_batches"])}
    st, _ = ex.train_resident(st, corpus, ranks.SEED, LR, 0, 8)
    want = _numpy_state(st.model)
    outs = [o["resident"] for o in two_ranks["outs"]]
    for name in want:
        np.testing.assert_array_equal(outs[0]["state"][name],
                                      outs[1]["state"][name], name)
    for name, err in _state_errs(outs[0]["state"], want).items():
        assert err <= _bound(name, 1), f"{name} {err}"
    for key, got in cvs.items():
        for out in outs:
            assert out[key]["utts"] == got["utts"] == 16
            for m in ("cv_loss", "cv_acc"):
                np.testing.assert_allclose(out[key][m], got[m], rtol=1e-6,
                                           atol=1e-9)


def _wav_samples(path):
    with wave.open(path) as w:
        return w.getnframes()


def _skewed_list(path, n_short=10, n_long=3):
    """The recipe's train wavs with their true durations: ``n_short`` in
    the short bucket (at most 22,000 samples) and ``n_long`` in the long
    one (boundaries 22,000 / 32,000)."""
    by_bucket = {True: [], False: []}
    for i in range(480):
        p = os.path.join(DATA, "train", f"train_{i}.wav")
        samples = _wav_samples(p)
        by_bucket[samples <= 22000].append((p, samples))
    picked = by_bucket[True][:n_short] + by_bucket[False][:n_long]
    lines = [json.dumps({"key": f"u{i}", "txt": "0" if i % 2 else "-1",
                         "wav": p, "duration": samples / 16000.0})
             for i, (p, samples) in enumerate(picked)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


BUCKETS = {"batch_size": 4, "bucket_boundaries": [22000, 32000]}


def test_bucket_schedule_keeps_ranks_in_lockstep(tmp_path):
    """On a skewed list (13 lines, most short) the two ranks' shards
    hold different counts per bucket; the bucket schedule, which every
    rank computes from the whole list, still gives both the same batch
    shapes in the same order and the same batch count, in train and in
    cv, and cv's fill rows (``valid`` 0) count every row once."""
    lst = _skewed_list(tmp_path / "skewed.list")
    conf = dict(DATASET_CONF, batch_conf=BUCKETS)
    for split in ("train", "cv"):
        for epoch in (0, 1):
            seqs, valid = [], 0.0
            for rank in range(2):
                ds = init_dataset(lst, conf, split=split, rank=rank,
                                  world_size=2)
                ds.set_epoch(epoch)
                batches = list(ds)
                seqs.append([(b["waves"].shape, b["target"].shape)
                             for b in batches])
                valid += sum(float(b["valid"].sum()) for b in batches)
            assert seqs[0] == seqs[1] and len(seqs[0]) >= 3, (split, seqs)
            assert len({s[0][1] for s in seqs[0]}) == 2  # both buckets
            if split == "cv":  # each line once, one wrapped around twice
                assert valid == 14


def test_bin_train_two_processes(tmp_path):
    """``bin.train --coordinator 127.0.0.1:P --num_processes 2
    --process_id r`` as two processes, host-fed (the skewed list,
    bucketed) then ``--device_resident``, one epoch each: both exit 0,
    log the same cv figures; rank 0 writes the config, ``init.pt``, the
    epoch checkpoint, ``final.pt``, metrics (finite losses) and
    TensorBoard, rank 1 nothing."""
    with open(os.path.join(RECIPE, "conf_torch", "mdtc_flagship.yaml")) as f:
        conf = yaml.safe_load(f)
    conf["dataset_conf"]["batch_conf"] = dict(BUCKETS)
    conf["dataset_conf"]["shuffle"] = False
    conf["model"]["hidden_dim"] = 16
    conf["model"]["backbone"].update(hidden_dim=16, num_stack=1,
                                     stack_size=2)
    config = tmp_path / "conf.yaml"
    config.write_text(yaml.safe_dump(conf))
    lst = _skewed_list(tmp_path / "train.list")
    ports = [free_port(), free_port()]
    runs = []
    for rank in range(2):
        argvs = []
        for j, extra in enumerate(([], ["--device_resident"])):
            argvs.append([
                "--config", str(config), "--train_data", lst,
                "--cv_data", lst, "--model_dir",
                str(tmp_path / f"m{j}_rank{rank}"), "--num_epochs", "1",
                "--min_duration", "20", "--device", "cpu",
                "--cmvn_file", os.path.join(DATA, "global_cmvn"),
                "--norm_var", "--coordinator", f"127.0.0.1:{ports[j]}",
                "--num_processes", "2", "--process_id", str(rank)] + extra)
        code = ("import sys, torch; torch.set_num_threads(1)\n"
                "from wekws_tpu_torch.bin import train\n"
                f"for argv in {argvs!r}:\n    train.main(argv)\n")
        runs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                [REPO, os.environ.get("PYTHONPATH", "")])),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in runs:
            logs.append(p.communicate(timeout=RUN_TIMEOUT_S)[0])
    finally:
        for p in runs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in runs] == [0, 0], "\n".join(logs)
    cv_lines = [[ln.split(" INFO ")[-1] for ln in log.splitlines()
                 if "CV loss" in ln] for log in logs]
    assert len(cv_lines[0]) == 2 and cv_lines[0] == cv_lines[1], cv_lines
    assert ["Epoch 0 done" in log for log in logs] == [True, False]
    for j in range(2):
        lead = tmp_path / f"m{j}_rank0"
        assert {"config.yaml", "init.pt", "0.pt", "final.pt",
                "metrics.jsonl", "tensorboard"} <= set(os.listdir(lead))
        with open(lead / "metrics.jsonl") as f:
            assert np.isfinite(json.loads(f.readline())["train_loss"])
        assert os.listdir(tmp_path / f"m{j}_rank1") == []


def test_init_and_pad_batch():
    """``distributed_init`` is a no-op for one process, and checks its
    flags for several; ``pad_batch_to_multiple`` is JAX's;
    ``mesh_devices`` counts the CPU as one device."""
    distributed_init("127.0.0.1:1", 1, 0)
    distributed_init(None, None, None)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="--coordinator"):
        distributed_init(None, 2, 0)
    with pytest.raises(ValueError, match="outside"):
        distributed_init("127.0.0.1:1", 2, 2)
    batch = _batch(b=5)
    batch["keys"] = [f"k{i}" for i in range(5)]
    got, want = pad_batch_to_multiple(copy.deepcopy(batch), 4), jax_pad(
        copy.deepcopy(batch), 4)
    assert got.keys() == want.keys() and got["keys"] == want["keys"]
    for k in ("waves", "wave_lengths", "target", "target_lengths", "valid"):
        np.testing.assert_array_equal(got[k], want[k], k)
    assert mesh_devices(1, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="has 1 cpu device"):
        mesh_devices(2, "cpu")


# ------------------------------------------------------------ serving

SERVE_DATASET = {"feats_type": "fbank",
                 "fbank_conf": {"num_mel_bins": 23, "frame_shift": 10,
                                "frame_length": 25, "dither": 1.0}}
SERVE_MODEL = {  # tests/test_torch_batch_kws.py's DS-TCN with a CTC head
    "input_dim": 23, "output_dim": 4, "hidden_dim": 16,
    "preprocessing": {"type": "linear"},
    "backbone": {"type": "tcn", "ds": True, "num_layers": 2,
                 "kernel_size": 4, "dropout": 0.0},
    "classifier": {"type": "element", "dropout": 0.0},
    "activation": {"type": "identity"},
}
STREAMS, STEP = 4, 8


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A JAX checkpoint (the port reads it), four streams of noise."""
    tmp = tmp_path_factory.mktemp("served")
    config = tmp / "config.yaml"
    config.write_text(yaml.dump({"dataset_conf": SERVE_DATASET,
                                 "model": SERVE_MODEL}))
    variables = jax_init_model(SERVE_MODEL).init(
        jax.random.PRNGKey(0), np.zeros((1, 10, 23), np.float32))
    ckpt = tmp / "final.ckpt"
    jax_save_checkpoint(str(ckpt), *(jax.tree_util.tree_map(
        np.asarray, dict(variables[k])) for k in ("params", "batch_stats")))
    tokens = tmp / "tokens.txt"
    tokens.write_text("<blk> 0\nh 1\ni 2\nx 3\n")
    rng = np.random.default_rng(5)
    waves = [(rng.standard_normal(12000 + 2000 * i) * 3000).astype(
        "<i2").tobytes() for i in range(STREAMS)]
    return str(ckpt), str(config), str(tokens), waves


class _Posteriors:
    """Keeps every step's posteriors of an engine, all rows in order."""

    def __init__(self, engine, attr):
        self.steps, self._attr = [], attr
        self._fn = getattr(engine, attr)
        setattr(engine, attr, self)

    def __call__(self, feats, active, reset, cache):
        probs, cache = self._fn(feats, active, reset, cache)
        blocks = probs if isinstance(probs, list) else [probs]
        self.steps.append(np.concatenate([np.asarray(p) for p in blocks]))
        return probs, cache


def _events(engine, waves):
    """Streams fed in 300 ms chunks, every step drained, stream 0 reset
    halfway, then a flush: the sorted events."""
    out = []

    def take(results):
        out.extend((i, tuple(sorted((k, v if not isinstance(v, float)
                                     else round(v, 4))
                                    for k, v in r.items())))
                   for i, r in results.items() if r and r.get("state") == 1)

    for off in range(0, max(len(w) for w in waves), 9600):
        for i, pcm in enumerate(waves):
            if off < len(pcm):
                engine.accept_wave(i, pcm[off:off + 9600])
        while True:
            results = engine.step()
            if not results:
                break
            take(results)
        if off == 9600:
            engine.reset_stream(0)
    take(engine.flush())
    return sorted(out)


def test_engines_split_over_devices(served):
    """The engines over ``["cpu", "cpu"]`` (two row blocks, each with its
    weights, caches and decode state) against the one-device engine and
    against JAX's engine on a 2-device mesh: each step's posteriors of
    every stream within 1e-4 abs + 1e-4 rel, the same events: CTC with
    host decode and with device decode, and max-pooling.  Three streams
    do not split over two devices."""
    ckpt, config, tokens, waves = served
    ctc = dict(threshold=0.05, num_streams=STREAMS, step_frames=STEP,
               min_frames=1)
    jeng = JaxBatchKeywordSpotter(ckpt, config, tokens, None,
                                  mesh=make_mesh(2), **ctc)
    jeng.set_keywords("hi,hx")
    jprobs = _Posteriors(jeng, "_step_jit")
    want = _events(jeng, waves)
    assert want
    for decode in (False, True):
        got = {}
        for devices in (["cpu", "cpu"], None):
            eng = BatchKeywordSpotter(ckpt, config, tokens, None,
                                      device_decode=decode,
                                      device=devices or "cpu", **ctc)
            eng.set_keywords("hi,hx")
            tap = _Posteriors(eng, "_step_fn")
            got[devices is None] = (_events(eng, waves), tap.steps)
        assert got[False][0] == got[True][0] == want, decode
        assert len(got[False][1]) == len(jprobs.steps)
        for split, one, jx in zip(got[False][1], got[True][1], jprobs.steps):
            np.testing.assert_allclose(split, one, atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(split, jx, atol=1e-4, rtol=1e-4)
    pool = {}
    for devices in (["cpu", "cpu"], None):
        eng = BatchMaxPoolSpotter(ckpt, config, 0.3, num_streams=STREAMS,
                                  step_frames=STEP, device=devices or "cpu")
        tap = _Posteriors(eng, "_step_fn")
        pool[devices is None] = (_events(eng, waves), tap.steps)
    assert pool[False][0] == pool[True][0] and pool[True][0]
    for split, one in zip(pool[False][1], pool[True][1]):
        np.testing.assert_allclose(split, one, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="multiple of the 2 devices"):
        BatchMaxPoolSpotter(ckpt, config, 0.3, num_streams=3,
                            device=["cpu", "cpu"])
