"""Device-resident epochs of the port (wekws_tpu_torch.data.resident,
``Executor.train_resident`` / ``cv_resident``, ``bin.train
--device_resident``) against the JAX package's data/resident.py on the
CPU: index matrices and staged arrays bit for bit, one resident step
against the port's host-fed step and against JAX's resident step on the
same weights, cv accounting over a padded tail."""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from wekws_tpu.data.audio import write_wav
from wekws_tpu.data.dataset import DataList as JaxDataList
from wekws_tpu.data.device_pipeline import (
    DeviceFeaturePipeline as JaxPipeline,
)
from wekws_tpu.data.resident import ResidentCorpus as JaxCorpus
from wekws_tpu.data.resident import make_resident_steps as jax_steps
from wekws_tpu.data.resident import stage_arrays as jax_stage_arrays
from wekws_tpu.data.resident import stage_data_list as jax_stage_data_list
from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.parallel import make_mesh
from wekws_tpu.text import CharTokenizer as JaxCharTokenizer
from wekws_tpu.train import Executor as JaxExecutor
from wekws_tpu.train import Trainer as JaxTrainer
from wekws_tpu_torch.bin import train
from wekws_tpu_torch.data import DeviceFeaturePipeline
from wekws_tpu_torch.data.dataset import DataList
from wekws_tpu_torch.data.resident import (
    ResidentCorpus,
    gather_rows,
    stage_arrays,
    stage_data_list,
)
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.text import CharTokenizer
from wekws_tpu_torch.tools.from_jax import model_from_jax
from wekws_tpu_torch.train import Executor, Trainer
from wekws_tpu_torch.train.executor import rank_columns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "examples", "synthetic")
CTC_DICT = os.path.join(REPO, "examples", "synthetic_ctc", "dict",
                        "dict.txt")
LR = 1e-3
STAGE_KEYS = ("waves", "wave_lengths", "target", "target_lengths", "valid")

DATASET_CONF = {
    "filter_conf": {"max_length": 2048, "min_length": 10},
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 40, "frame_shift": 10,
                   "frame_length": 25, "dither": 0.0},
    "batch_conf": {"batch_size": 8},
}
AUG_CONF = dict(DATASET_CONF, spec_aug=True, spec_aug_conf={
    "num_t_mask": 1, "num_f_mask": 1, "max_t": 10, "max_f": 5})
AUG_CONF["fbank_conf"] = dict(DATASET_CONF["fbank_conf"], dither=1.0,
                              dither_mode="wave")
DS_TCN_CONF = {  # tests/test_resident.py's
    "input_dim": 40, "output_dim": 3, "hidden_dim": 32,
    "preprocessing": {"type": "linear"},
    "backbone": {"type": "tcn", "ds": True, "num_layers": 2,
                 "kernel_size": 4, "dropout": 0.0},
    "classifier": {"type": "global", "dropout": 0.0},
    "activation": {"type": "identity"},
}
MDTC_CONF = {
    "input_dim": 40, "output_dim": 1, "hidden_dim": 32,
    "preprocessing": {"type": "linear"},
    "backbone": {"type": "mdtc", "num_stack": 2, "stack_size": 2,
                 "kernel_size": 3, "hidden_dim": 32, "causal": True,
                 "fused_train": True},
}
# (model config, criterion, target of row i)
ARCHS = {
    "ds_tcn": (DS_TCN_CONF, "ce", lambda i: i % 3),
    "mdtc": (MDTC_CONF, "max_pooling", lambda i: i % 2 - 1),
}


def synth_arrays(n, arch="ds_tcn", s=4000, seed=0):
    """int16 rows: a tone per class in noise (tests/test_resident.py's),
    the last row shorter, its tail zero."""
    rng = np.random.default_rng(seed)
    t = np.arange(s) / 16000.0
    target_of = ARCHS[arch][2]
    waves = np.zeros((n, s), np.int16)
    target = np.zeros((n,), np.int32)
    for i in range(n):
        target[i] = target_of(i)
        w = 0.3 * np.sin(2 * np.pi * 400 * (i % 3 + 1) * t)
        w += 0.02 * rng.standard_normal(s)
        waves[i] = np.clip(np.rint(w * 32768.0), -32768, 32767)
    lengths = np.full((n,), s, np.int32)
    lengths[-1] = s - 800
    waves[-1, lengths[-1]:] = 0
    return {"waves": waves, "wave_lengths": lengths, "target": target,
            "target_lengths": np.ones((n,), np.int32)}


def port_trainer(arch, dataset_conf=DATASET_CONF, state=None):
    """The port's Trainer on the CPU, from JAX weights when ``state``
    (params, batch_stats) is given, else from a seeded draw."""
    conf, crit, _ = ARCHS[arch]
    if state is None:
        model = init_model(conf, torch.Generator().manual_seed(0))
    else:
        model = model_from_jax(*state, conf)
    return Trainer(model, DeviceFeaturePipeline.from_conf(dataset_conf),
                   DeviceFeaturePipeline.from_conf(dataset_conf,
                                                   training=False),
                   crit, grad_clip=5.0, min_duration=5, device="cpu")


def jax_trainer(arch, arrays):
    """JAX Trainer and its initial state (the unfused exact-BN MDTC:
    tests/test_torch_fused_train.py pins the fused route against it)."""
    conf, crit, _ = ARCHS[arch]
    conf = dict(conf, backbone=dict(conf["backbone"], fused_train=False))
    trainer = JaxTrainer(jax_init_model(conf),
                         JaxPipeline.from_conf(DATASET_CONF, True),
                         JaxPipeline.from_conf(DATASET_CONF, False), crit,
                         learning_rate=LR, grad_clip=5.0, min_duration=5)
    mesh = make_mesh(1)
    state = trainer.init_state(jax.random.PRNGKey(0),
                               {k: v[:8] for k, v in arrays.items()}, mesh)
    return trainer, state, mesh


@pytest.mark.parametrize("n,b,epoch,shuffle,drop_last", [
    (37, 5, 0, True, True), (37, 5, 3, True, False), (10, 4, 1, False, True),
    (10, 4, 0, False, False), (64, 8, 7, True, True), (9, 9, 2, True, False),
])
def test_index_matrices_equal_jax(n, b, epoch, shuffle, drop_last):
    port = ResidentCorpus(arrays={}, n=n, audio_seconds=0.0)
    ref = JaxCorpus(arrays={}, n=n, audio_seconds=0.0)
    got = port.epoch_index(epoch, b, shuffle=shuffle, drop_last=drop_last)
    want = ref.epoch_index(epoch, b, shuffle=shuffle, drop_last=drop_last)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for g, w in zip(port.cv_index(b), ref.cv_index(b)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_epoch_index_is_datalist_order():
    """The staged rows' order is the port's DataList Random(epoch) order
    (which is JAX's), cut to whole batches; below one batch it raises."""
    n = 37
    corpus = ResidentCorpus(arrays={}, n=n, audio_seconds=0.0)
    for epoch in (0, 1, 5):
        orders = []
        for cls in (DataList, JaxDataList):
            dl = cls([str(i) for i in range(n)], shuffle=True,
                     partition=False)
            dl.set_epoch(epoch)
            orders.append([int(s["src"]) for s in dl])
        assert orders[0] == orders[1]
        got = corpus.epoch_index(epoch, batch_size=5).reshape(-1).tolist()
        assert got == orders[0][:len(got)]
    for cls in (ResidentCorpus, JaxCorpus):
        with pytest.raises(ValueError, match="batch_size"):
            cls(arrays={}, n=3, audio_seconds=0.0).epoch_index(0, 4)


@pytest.fixture(scope="module")
def data_list(tmp_path_factory):
    """Nine wavs of different lengths (one too short for filter_conf)
    with class and token transcripts."""
    root = tmp_path_factory.mktemp("resident_list")
    rng = np.random.default_rng(5)
    lines = {"class": [], "ctc": []}
    for i in range(9):
        n = 60 if i == 4 else 2400 + 331 * i
        p = str(root / f"u{i}.wav")
        write_wav(p, (0.2 * rng.standard_normal(n)).astype(np.float32),
                  16000)
        for kind, txt in (("class", str(i % 3)),
                          ("ctc", ["4123", "12", "3", "21"][i % 4])):
            lines[kind].append(json.dumps({"key": f"u{i}", "txt": txt,
                                           "wav": p}))
    paths = {}
    for kind, ls in lines.items():
        paths[kind] = root / f"{kind}.list"
        paths[kind].write_text("\n".join(ls) + "\n")
    return {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("case", ["train", "cv", "ctc"])
def test_stage_data_list_equals_jax(data_list, case):
    """The same list staged by both packages (train and cv splits; CTC
    targets (N, U)): int16 waves, lengths, targets, validity, keys and
    audio seconds bit for bit."""
    split = "cv" if case == "cv" else "train"
    tokens = {}
    if case == "ctc":
        tokens = {"port": CharTokenizer(CTC_DICT, unk="<filler>"),
                  "jax": JaxCharTokenizer(CTC_DICT, unk="<filler>")}
    lst = data_list["ctc" if case == "ctc" else "class"]
    got = stage_data_list(lst, AUG_CONF, tokens.get("port"), split=split,
                          device="cpu")
    want = jax_stage_data_list(lst, AUG_CONF, tokens.get("jax"),
                               split=split, rank=0, world_size=1)
    want.wait_uploaded()
    assert got.n == want.n == 8  # u4 is below min_length
    assert got.keys == want.keys
    assert got.audio_seconds == want.audio_seconds
    np.testing.assert_array_equal(got.host_wave_lengths,
                                  want.host_wave_lengths)
    assert set(got.arrays) == set(want.arrays) == set(STAGE_KEYS)
    for key in STAGE_KEYS:
        g, w = got.arrays[key].numpy(), np.asarray(want.arrays[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert got.arrays["waves"].dtype == torch.int16
    assert got.arrays["target"].dim() == (2 if case == "ctc" else 1)
    assert got.nbytes == want.nbytes
    assert got.wait_uploaded() is not None


@pytest.mark.parametrize("case,item", [
    ("speed_perturb", "item 10"), ("noise_prob", "item 10"),
    ("reverb_prob", "item 10"),
    pytest.param("world_size", "global", id="world_size-item 13"),
    pytest.param("mesh", "columns", id="mesh-item 13"),
    pytest.param("stage_arrays_mesh", "cv columns",
                 id="stage_arrays_mesh-item 13"),
])
def test_unported_staging_raises(data_list, case, item):
    """Several processes (ported since, A.13): ``world_size=2`` stages
    the JAX package's global corpus, its ``stage_data_list(rank=r,
    world_size=2)`` shards concatenated in rank order and padded to the
    longest row (every rank stages all of it); each rank trains on its
    columns of an epoch's index rows and takes its columns of cv's
    batches, which count every row once.  A train config with waveform
    augmentation (item 10, ported since) raises the JAX package's
    ValueError without ``device_aug=True``, as JAX's does, and with it
    stages the raw waves as JAX's does; a cv split drops the
    augmentation instead."""
    conf = dict(DATASET_CONF)
    if case == "speed_perturb":
        conf["speed_perturb"] = True
    elif case in ("noise_prob", "reverb_prob"):
        conf[case] = 0.5
    if item != "item 10":
        got = stage_data_list(data_list["class"], conf, split="train",
                              device="cpu", world_size=2)
        if item == "global":
            shards = [jax_stage_data_list(data_list["class"], conf,
                                          split="train", rank=r,
                                          world_size=2) for r in (0, 1)]
            assert got.keys == shards[0].keys + shards[1].keys
            assert got.n == shards[0].n + shards[1].n == 10
            smax = max(s.arrays["waves"].shape[1] for s in shards)
            for key in STAGE_KEYS:
                want = [np.asarray(s.arrays[key]) for s in shards]
                if key == "waves":
                    want = [np.pad(w, ((0, 0), (0, smax - w.shape[1])))
                            for w in want]
                np.testing.assert_array_equal(got.arrays[key].numpy(),
                                              np.concatenate(want))
            np.testing.assert_array_equal(
                got.host_wave_lengths,
                np.concatenate([s.host_wave_lengths for s in shards]))
        elif item == "columns":
            rows = got.epoch_index(3, 4)
            parts = [rank_columns(rows, r, 2) for r in (0, 1)]
            assert [p.shape for p in parts] == [(2, 2), (2, 2)]
            np.testing.assert_array_equal(np.concatenate(parts, axis=1),
                                          rows)
            with pytest.raises(ValueError, match="does not split"):
                rank_columns(got.epoch_index(3, 3), 0, 2)
        else:
            idx, ok = got.cv_index(4)
            seen = np.zeros(got.n)
            for r in (0, 1):
                np.add.at(seen, rank_columns(idx, r, 2).ravel(),
                          rank_columns(ok, r, 2).ravel())
            np.testing.assert_array_equal(seen, np.ones(got.n))
        return
    for stage in (stage_data_list, jax_stage_data_list):
        with pytest.raises(ValueError, match="device_aug=True"):
            stage(data_list["class"], conf, split="train")
    got = stage_data_list(data_list["class"], conf, split="train",
                          device="cpu", device_aug=True)
    want = jax_stage_data_list(data_list["class"], conf, split="train",
                               rank=0, world_size=1, device_aug=True)
    want.wait_uploaded()
    assert got.n == want.n == 8 and got.keys == want.keys
    for key in STAGE_KEYS:
        np.testing.assert_array_equal(got.arrays[key].numpy(),
                                      np.asarray(want.arrays[key]))
    assert stage_data_list(data_list["class"], conf, split="cv",
                           device="cpu").n == 8


def test_resident_step_is_host_step():
    """The fused MDTC with dither and spec_aug: a resident step and
    Trainer.train_step on the same rows from the same state, seed and
    step agree (loss, accuracy, every parameter and buffer)."""
    arrays = synth_arrays(16, "mdtc")
    trainer = port_trainer("mdtc", AUG_CONF)
    state = trainer.init_state()
    host_state = copy.deepcopy(state)
    corpus = stage_arrays(arrays, device="cpu")
    epoch_idx = corpus.epoch_index(0, 8)
    for rows in epoch_idx:
        state, got = trainer.train_step(
            state, gather_rows(corpus.arrays, torch.from_numpy(rows)), 3, LR)
        host_state, want = trainer.train_step(
            host_state, {k: v[rows] for k, v in arrays.items()}, 3, LR)
        for key in ("loss", "acc", "grad_norm"):
            assert abs(float(got[key]) - float(want[key])) <= 1e-6, key
    assert state.step == host_state.step == 2
    want = host_state.model.state_dict()
    for name, val in state.model.state_dict().items():
        err = float((val.double() - want[name].double()).abs().max())
        assert err <= 1e-6, f"{name}: {err}"


@pytest.mark.parametrize("arch", ["ds_tcn", "mdtc"])
def test_resident_step_matches_jax(arch):
    """One resident step of each package on the same weights and staged
    rows (no dither, no spec_aug): loss 1e-5 rel, the gradient's norm
    1e-4 rel, parameters within tests/test_torch_training.py's
    2 * lr + 1e-5, BN running statistics 1e-4; against eager JAX (its
    jitted CPU gradients drift).  Adam's first update is
    lr * g / (|g| + eps), about lr * sign(g), so that bound alone would
    pass any update.  Where |g| is above twice that file's gradient
    bound (1e-4 of max(1, max |g|)), g has the same sign in both
    packages, and there the updated parameters agree within lr * 1e-3.
    """
    arrays = synth_arrays(16, arch)
    jtrainer, jstate, mesh = jax_trainer(arch, arrays)
    init = jax.device_get((jstate.params, jstate.batch_stats))
    epoch_idx = np.random.default_rng(1).permutation(16).astype(
        np.int32).reshape(2, 8)
    jcorpus = jax_stage_arrays(arrays, mesh=mesh, force_upload="sync")
    jstep, _ = jax_steps(jtrainer, mesh, 2)
    with jax.disable_jit():
        jstate, jm = jstep(jstate, jcorpus.arrays, {},
                           jax.numpy.asarray(epoch_idx),
                           jax.numpy.zeros((), jax.numpy.int32),
                           jax.random.key(7, impl="rbg"),
                           jax.numpy.asarray(LR, jax.numpy.float32))
    want = model_from_jax(*jax.device_get(
        (jstate.params, jstate.batch_stats)), ARCHS[arch][0]).state_dict()

    trainer = port_trainer(arch, state=init)
    state = trainer.init_state()
    corpus = stage_arrays(arrays, device="cpu")
    state, m = trainer.train_step(
        state, gather_rows(corpus.arrays, torch.from_numpy(epoch_idx[0])),
        7, LR)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    for name, val in state.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        tol = 1e-4 if "running" in name else 2 * LR + 1e-5
        err = float((val - want[name]).abs().max())
        assert err <= tol, f"{name}: {err} > {tol}"
    pinned = 0
    for name, p in state.model.named_parameters():
        g = p.grad.abs()
        sure = g > 2e-4 * max(1.0, float(g.max()))
        pinned += int(sure.sum())
        if sure.any():
            err = float((p.detach() - want[name])[sure].abs().max())
            assert err <= LR * 1e-3, f"{name}: {err} where |g| is large"
    assert pinned > 0


def test_train_resident_lowers_loss():
    trainer = port_trainer("ds_tcn")
    corpus = stage_arrays(synth_arrays(48), device="cpu")
    ex = Executor(trainer, log_interval=100)
    state = trainer.init_state()
    losses = []
    for epoch in range(4):
        state, summary = ex.train_resident(state, corpus, 3, LR, epoch, 8)
        assert summary["batches"] == 6
        losses.append(summary["train_loss"])
    assert losses[-1] < losses[0], losses
    assert state.step == 24


def test_cv_resident_exact_tail():
    """n=19 at B=8: the padded tail counts no row twice.  Equal to
    Executor.cv over the same rows as three host batches and to JAX's
    cv_resident on the same weights (1e-5)."""
    arrays = synth_arrays(19)
    jtrainer, jstate, mesh = jax_trainer("ds_tcn", arrays)
    jcorpus = jax_stage_arrays(arrays, mesh=mesh, force_upload="sync")
    want = JaxExecutor(jtrainer, mesh).cv_resident(jstate, jcorpus, 8)
    trainer = port_trainer("ds_tcn", state=jax.device_get(
        (jstate.params, jstate.batch_stats)))
    state = trainer.init_state()
    ex = Executor(trainer)
    got = ex.cv_resident(state, stage_arrays(arrays, device="cpu"), 8)
    host = ex.cv(state, [{k: v[i:i + 8] for k, v in arrays.items()}
                         for i in (0, 8, 16)])
    assert got["utts"] == host["utts"] == want["utts"] == 19
    for key in ("cv_loss", "cv_acc"):
        np.testing.assert_allclose(got[key], host[key], rtol=1e-5)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)


def test_bin_train_device_resident(tmp_path):
    """``bin.train --device_resident --device cpu``: one epoch of the
    recipe's MDTC (2 x 2 blocks, C=32) on 16 committed wavs."""
    with open(os.path.join(RECIPE, "conf_torch", "mdtc_flagship.yaml")) as f:
        conf = yaml.safe_load(f)
    conf["model"]["hidden_dim"] = 32
    conf["model"]["backbone"].update(hidden_dim=32, num_stack=2,
                                     stack_size=2)
    conf["dataset_conf"]["batch_conf"]["batch_size"] = 8
    config = tmp_path / "conf.yaml"
    config.write_text(yaml.safe_dump(conf))
    lists = {}
    for split, n in (("train", 16), ("dev", 8)):
        lists[split] = tmp_path / f"{split}.list"
        lists[split].write_text("".join(json.dumps({
            "key": f"{split}_{i}", "txt": "0" if i % 2 == 0 else "-1",
            "wav": os.path.join(RECIPE, "data", split, f"{split}_{i}.wav"),
        }) + "\n" for i in range(n)))
    exp = tmp_path / "exp"
    train.main(["--config", str(config), "--train_data",
                str(lists["train"]), "--cv_data", str(lists["dev"]),
                "--model_dir", str(exp), "--min_duration", "20",
                "--cmvn_file", os.path.join(RECIPE, "data", "global_cmvn"),
                "--norm_var", "--num_epochs", "1", "--device_resident",
                "--device", "cpu"])
    for name in ("config.yaml", "init.pt", "0.pt", "0.yaml", "final.pt",
                 "metrics.jsonl"):
        assert (exp / name).exists(), name
    with open(exp / "metrics.jsonl") as f:
        record = json.loads(f.readline())
    assert record["batches"] == 2 and np.isfinite(record["train_loss"])
    with open(exp / "0.yaml") as f:
        assert np.isfinite(float(yaml.safe_load(f)["cv_loss"]))
