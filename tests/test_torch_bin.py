"""The port's recipe CLIs (wekws_tpu_torch.bin) on the CPU: a tiny MDTC
(2 x 2 blocks, C=32, the fused training passes and fused fbank by their
plain versions) trained one epoch by ``bin.train`` on 32 committed wavs,
then averaged, scored and DET-evaluated; every output read back with
the JAX package's readers.  Also resuming from a JAX-package ``.ckpt``,
the flags of unported items, and the entry points' default device (the
CTC CLIs' too)."""

import json
import os
import socket
import struct
import time

import numpy as np
import pytest
import torch
import yaml

from wekws_tpu.eval import compute_det as jax_compute_det
from wekws_tpu.eval import load_label_and_score as jax_load_label_and_score
from wekws_tpu.eval import write_stats_file as jax_write_stats_file
from wekws_tpu.train import load_checkpoint_info as jax_load_checkpoint_info
from wekws_tpu.train import tensorboard as jax_tensorboard
from wekws_tpu_torch.bin import (
    average_model,
    compute_accuracy,
    compute_det,
    compute_det_ctc,
    export_model,
    score,
    score_ctc,
    stream_score_ctc,
    train,
)
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.train import load_checkpoint
from wekws_tpu_torch.train import tensorboard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "examples", "synthetic")
DATA = os.path.join(RECIPE, "data")
FIXTURE = os.path.join(RECIPE, "exp", "ds_tcn")
METRIC_KEYS = {"epoch", "lr", "train_loss", "train_acc", "batches",
               "audio_seconds_per_s"}


def write_list(path, split, n):
    lines = []
    for i in range(n):
        lines.append(json.dumps({
            "key": f"{split}_{i}", "txt": "0" if i % 2 == 0 else "-1",
            "wav": os.path.join(DATA, split, f"{split}_{i}.wav"),
            "duration": 1.5}))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipe")
    with open(os.path.join(RECIPE, "conf_torch", "mdtc_flagship.yaml")) as f:
        conf = yaml.safe_load(f)
    conf["model"]["hidden_dim"] = 32
    conf["model"]["backbone"].update(hidden_dim=32, num_stack=2,
                                     stack_size=2)
    conf["dataset_conf"]["batch_conf"]["batch_size"] = 16
    config = root / "conf.yaml"
    config.write_text(yaml.safe_dump(conf))
    lists = {s: write_list(root / f"{s}.list", s, n)
             for s, n in (("train", 32), ("dev", 16), ("test", 16))}
    exp = root / "exp"
    train.main(["--config", str(config), "--train_data", lists["train"],
                "--cv_data", lists["dev"], "--model_dir", str(exp),
                "--min_duration", "20", "--seed", "666",
                "--cmvn_file", os.path.join(DATA, "global_cmvn"),
                "--norm_var", "--num_epochs", "1", "--device", "cpu"])
    picked = average_model.main(["--dst_model", str(exp / "avg_1.pt"),
                                 "--src_path", str(exp), "--num", "1",
                                 "--val_best", "--device", "cpu"])
    n_scored = score.main(["--config", str(exp / "config.yaml"),
                           "--test_data", lists["test"], "--checkpoint",
                           str(exp / "avg_1.pt"), "--score_file",
                           str(exp / "score.txt"), "--device", "cpu"])
    compute_det.main(["--keyword", "0", "--test_data", lists["test"],
                      "--score_file", str(exp / "score.txt"),
                      "--stats_file", str(exp / "stats.0.txt"),
                      "--device", "cpu"])
    return {"exp": exp, "lists": lists, "picked": picked,
            "n_scored": n_scored}


def test_train_outputs_parse_in_jax_formats(recipe):
    exp = recipe["exp"]
    with open(exp / "config.yaml") as f:
        configs = yaml.safe_load(f)
    model_conf = configs["model"]
    assert model_conf["input_dim"] == 40 and model_conf["output_dim"] == 1
    assert os.path.isabs(model_conf["cmvn"]["cmvn_file"])
    assert model_conf["backbone"]["fused_train"] is True
    info = jax_load_checkpoint_info(str(exp / "0.pt"))
    assert info["epoch"] == 0.0 and info["lr"] == 0.002
    assert np.isfinite(info["cv_loss"])
    assert os.readlink(exp / "final.pt") == "0.pt"
    records = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    assert len(records) == 1 and set(records[0]) == METRIC_KEYS
    assert records[0]["batches"] == 2 and np.isfinite(records[0]["train_loss"])
    for name in ("init.pt", "0.pt", "avg_1.pt"):
        model = init_model(model_conf)
        model.load_state_dict(load_checkpoint(str(exp / name)))
    init, trained = (load_checkpoint(str(exp / n)) for n in ("init.pt",
                                                             "0.pt"))
    assert not torch.equal(init["classifier.linear.weight"],
                           trained["classifier.linear.weight"])
    assert [os.path.basename(p) for p in recipe["picked"]] == ["0.pt"]


def test_score_and_det_parse_in_jax_formats(recipe, tmp_path):
    exp, test_list = recipe["exp"], recipe["lists"]["test"]
    assert recipe["n_scored"] == 16
    keyword, filler, filler_seconds = jax_load_label_and_score(
        "0", test_list, str(exp / "score.txt"))
    assert len(keyword) == 8 and len(filler) == 8
    assert filler_seconds == pytest.approx(8 * 1.5)
    for scores in list(keyword.values()) + list(filler.values()):
        assert len(scores) > 100 and all(0.0 <= s <= 1.0 for s in scores)
    jax_write_stats_file(jax_compute_det(keyword, filler, filler_seconds),
                         str(tmp_path / "stats.txt"))
    assert (exp / "stats.0.txt").read_text() == \
        (tmp_path / "stats.txt").read_text()


def read_records(path):
    data = open(path, "rb").read()
    out, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == \
            jax_tensorboard._masked_crc(header)
        record = data[pos + 12:pos + 12 + n]
        crc = data[pos + 12 + n:pos + 16 + n]
        assert struct.unpack("<I", crc)[0] == \
            jax_tensorboard._masked_crc(record)
        out.append(record)
        pos += 16 + n
    return out


def test_tensorboard_matches_jax_writer(recipe, tmp_path, monkeypatch):
    """bin/train's event file is framed as TensorBoard reads it, and the
    port's writer gives the JAX writer's bytes for the same scalars at a
    fixed wall time."""
    (event,) = os.listdir(recipe["exp"] / "tensorboard")
    records = read_records(recipe["exp"] / "tensorboard" / event)
    assert len(records) == 2  # the file version, epoch 0's scalars
    wall = struct.unpack("<d", records[0][1:9])[0]
    assert records[0] == jax_tensorboard._encode_event(
        wall, file_version="brain.Event:2")
    for tag in (b"cv_loss", b"cv_acc", b"lr", b"train_loss"):
        assert tag in records[1]
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    for name, mod in (("port", tensorboard), ("jax", jax_tensorboard)):
        with mod.SummaryWriter(str(tmp_path / name)) as writer:
            writer.add_scalars({"cv_loss": 0.25, "lr": 1e-3}, step=3)
            writer.add_scalar("train_loss", 1.5, step=4)
    (a,), (b,) = (os.listdir(tmp_path / n) for n in ("port", "jax"))
    assert a == b
    assert (tmp_path / "port" / a).read_bytes() == \
        (tmp_path / "jax" / b).read_bytes()


def test_resume_from_jax_checkpoint(tmp_path):
    """--checkpoint with the JAX fixture's 11.ckpt (DS-TCN, C=48):
    training goes on at epoch 12 with the sidecar's lr."""
    with open(os.path.join(FIXTURE, "config.yaml")) as f:
        configs = yaml.safe_load(f)
    configs["dataset_conf"]["batch_conf"]["batch_size"] = 8
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump(configs))
    train_list = write_list(tmp_path / "train.list", "train", 8)
    cv_list = write_list(tmp_path / "dev.list", "dev", 8)
    exp = tmp_path / "exp"
    train.main(["--config", str(config), "--train_data", train_list,
                "--cv_data", cv_list, "--model_dir", str(exp),
                "--checkpoint", os.path.join(FIXTURE, "11.ckpt"),
                "--min_duration", "20", "--cmvn_file",
                os.path.join(DATA, "global_cmvn"), "--norm_var",
                "--num_epochs", "13", "--device", "cpu"])
    assert sorted(p for p in os.listdir(exp) if p.endswith(".pt")) == \
        ["12.pt", "final.pt"]
    info = jax_load_checkpoint_info(str(exp / "12.pt"))
    want = jax_load_checkpoint_info(os.path.join(FIXTURE, "11.ckpt"))
    assert info["epoch"] == 12.0 and info["lr"] == want["lr"]


def aug_stores(root):
    """Noise and RIR stores of a few seeded wavs, through the port's
    ``write_wav`` and ``make_blob``: {conf key: store path}."""
    from wekws_tpu_torch.data.audio import write_wav
    from wekws_tpu_torch.tools.make_blob import make_blob

    rng = np.random.default_rng(3)
    out = {}
    for corpus, items in (("noise", (("noise_0", 2000), ("music_1", 700))),
                          ("reverb", (("rir_0", 400),))):
        scp = []
        for key, n in items:
            p = root / f"{key}.wav"
            write_wav(str(p), (0.05 * rng.standard_normal(n)).astype(
                np.float32), 16000)
            scp.append(f"{key} {p}")
        (root / f"{corpus}.scp").write_text("\n".join(scp) + "\n")
        make_blob(str(root / f"{corpus}.scp"), str(root / f"{corpus}_store"))
        out[f"{corpus}_source"] = str(root / f"{corpus}_store")
    return out


@pytest.mark.parametrize("flag,item", [
    pytest.param(["--device_resident"], "item 10", id="flag0-item 10"),
    pytest.param(["--coordinator", "localhost:1234"], "one process",
                 id="flag1-item 13"),
    pytest.param(["--num_processes", "2"], "--coordinator",
                 id="flag2-item 13"),
    pytest.param(["--process_id", "0"], "one process", id="flag3-item 13"),
])
def test_unported_flags_raise(tmp_path, monkeypatch, flag, item):
    """The data-parallel flags (ported since, A.13): ``--coordinator`` or
    ``--process_id`` alone trains one process, as the JAX CLI does (no
    process group; the missing list is what stops this run), and
    ``--num_processes 2`` without a coordinator raises
    (tests/test_torch_parallel.py trains two).  ``--device_resident``
    with waveform augmentation (item 10, ported since) trains: speed_
    perturb, noise and reverb on a tiny list and tiny stores, one epoch,
    with a ``DeviceWaveAug`` attached to the train pipeline and run each
    step."""
    with open(os.path.join(RECIPE, "conf_torch", "mdtc_flagship.yaml")) as f:
        conf = yaml.safe_load(f)
    conf["dataset_conf"]["speed_perturb"] = True
    args = ["--model_dir", str(tmp_path / "m"), "--device", "cpu"] + flag
    if item != "item 10":
        config = tmp_path / "conf.yaml"
        config.write_text(yaml.safe_dump(conf))
        argv = ["--config", str(config), "--train_data",
                str(tmp_path / "t"), "--cv_data", str(tmp_path / "v")]
        if item == "one process":
            with pytest.raises(FileNotFoundError, match="t"):
                train.main(argv + args)
            assert (tmp_path / "m" / "init.pt").exists()
        else:
            with pytest.raises(ValueError, match=item):
                train.main(argv + args)
            assert not (tmp_path / "m").exists()
        assert not torch.distributed.is_initialized()
        return
    from wekws_tpu_torch.data import device_aug

    conf["dataset_conf"].update(aug_stores(tmp_path), noise_prob=0.6,
                                reverb_prob=0.4)
    conf["dataset_conf"]["batch_conf"]["batch_size"] = 4
    conf["model"]["hidden_dim"] = 16
    conf["model"]["backbone"].update(hidden_dim=16, num_stack=1,
                                     stack_size=2)
    config = tmp_path / "conf.yaml"
    config.write_text(yaml.safe_dump(conf))
    lists = {split: write_list(tmp_path / f"{split}.list", split, 4)
             for split in ("train", "dev")}
    applied = []
    apply = device_aug.DeviceWaveAug.apply

    def counted(self, waves, lengths, draws):
        applied.append((self, tuple(waves.shape)))
        return apply(self, waves, lengths, draws)

    monkeypatch.setattr(device_aug.DeviceWaveAug, "apply", counted)
    train.main(["--config", str(config), "--train_data", lists["train"],
                "--cv_data", lists["dev"], "--num_epochs", "1",
                "--min_duration", "20", "--cmvn_file",
                os.path.join(DATA, "global_cmvn"), "--norm_var"] + args)
    assert len(applied) == 1  # 4 rows at B=4: one step, none in cv
    aug, shape = applied[0]
    assert aug.speed_perturb and aug.n_noise_rows == 16 and aug.n_rirs == 1
    assert shape[0] == 4
    with open(tmp_path / "m" / "metrics.jsonl") as f:
        assert np.isfinite(json.loads(f.readline())["train_loss"])


@pytest.mark.parametrize("entry", ["train", "average_model", "score",
                                   "compute_det", "score_ctc",
                                   "compute_det_ctc", "stream_score_ctc",
                                   "compute_accuracy",
                                   "export_model_stablehlo"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    """Without ``--device`` each runs on the GPU, or raises where there
    is none, before reading its inputs."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py drives these on it")
    x = str(tmp_path / "missing")
    argv = {
        "train": (train, ["--config", x, "--train_data", x, "--cv_data", x,
                          "--model_dir", x]),
        "average_model": (average_model, ["--dst_model", x, "--src_path",
                                          x]),
        "score": (score, ["--config", x, "--test_data", x, "--checkpoint",
                          x, "--score_file", x]),
        "compute_det": (compute_det, ["--test_data", x, "--keyword", "0",
                                      "--score_file", x, "--stats_file",
                                      x]),
        "score_ctc": (score_ctc, ["--config", x, "--test_data", x,
                                  "--checkpoint", x, "--score_file", x,
                                  "--dict", x, "--keywords", "123"]),
        "compute_det_ctc": (compute_det_ctc, ["--test_data", x,
                                              "--keywords", "123",
                                              "--score_file", x]),
        "stream_score_ctc": (stream_score_ctc, [
            "--config", x, "--checkpoint", x, "--test_data", x,
            "--token_file", x, "--keywords", "123", "--score_file", x]),
        "compute_accuracy": (compute_accuracy, [
            "--config", x, "--test_data", x, "--checkpoint", x]),
        "export_model_stablehlo": (export_model, [
            "--config", x, "--checkpoint", x, "--output_dir", x, "--format",
            "stablehlo"]),
    }
    mod, args = argv[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(args)
