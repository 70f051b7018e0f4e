"""The public recipes on the port, part 1: the miniature corpora of
``wekws_tpu_torch.tools.public_layouts`` read by each recipe's own
``local/prepare_data.py``; each ``conf_torch/*.yaml`` is its
``conf/*.yaml`` with the port's knobs and nothing else changed, and
builds in the port; a checkpoint's sidecar is found through the
``final.pt`` link (the fine-tune of ``run_ctc_torch.sh --trainbase
true`` resumes from it); ``examples/hey_snips/run_torch.sh`` runs every
stage on the CPU, its stages 0-1 against the JAX package's tools.
(``test_torch_public_recipes_{xiaowen,ctc,commands}.py`` run the other
scripts.)"""

import copy
import filecmp
import glob
import json
import os
import subprocess
import sys

import pytest
import torch
import yaml
from public_recipes import (
    REPO,
    SEED,
    cut_config,
    read_list,
    recipe_copy,
    run_script,
    same_stage_1_as_jax,
    stages_done,
    write_layout,
)

from wekws_tpu_torch.data.device_pipeline import DeviceFeaturePipeline
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.tools import public_layouts
from wekws_tpu_torch.train.checkpoint import (
    link_final,
    load_checkpoint_info,
    save_checkpoint,
)

CONFIGS = sorted(
    os.path.relpath(p, os.path.join(REPO, "examples"))
    for name in ("hey_snips", "hi_xiaowen", "speechcommand_v1")
    for p in glob.glob(os.path.join(REPO, "examples", name, "conf_torch",
                                    "*.yaml")))


def prepare(recipe, *argv):
    """A recipe's local/prepare_data.py (numpy-free, no torch)."""
    return subprocess.run([sys.executable, "local/prepare_data.py", *argv],
                          cwd=recipe, check=True, capture_output=True,
                          text=True, timeout=60).stdout


def table(path):
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n").split(" ", 1) for line in f]


def test_snips_layout_reads_through_prepare_data(tmp_path):
    recipe = recipe_copy(tmp_path, "hey_snips")
    local = os.path.join(recipe, "data", "local")
    write_layout("snips", local, "--train", "6", "--dev", "4", "--test", "5")
    out = prepare(recipe, local, "data")
    assert out.split("\n")[:3] == ["train: 6 utts", "dev: 4 utts",
                                   "test: 5 utts"]
    for split, n in (("train", 6), ("dev", 4), ("test", 5)):
        with open(os.path.join(local, f"{split}.json")) as f:
            entries = json.load(f)
        assert {"id", "audio_file_path", "is_hotword"} <= set(entries[0])
        labels = dict(table(os.path.join(recipe, "data", split, "text")))
        wavs = dict(table(os.path.join(recipe, "data", split, "wav.scp")))
        assert len(labels) == len(wavs) == n
        for e in entries:
            assert labels[e["id"]] == ("0" if e["is_hotword"] else "-1")
            assert os.path.isfile(wavs[e["id"]])
        assert sum(e["is_hotword"] for e in entries) == (n + 1) // 2


def test_mobvoi_layout_reads_through_prepare_data(tmp_path):
    """With run_torch.sh's dict (each keyword named by its id) every
    label is the json's keyword_id; with run.sh's dict (<HI_XIAOWEN>,
    ...) the JAX package's pipeline reads every label as the filler: the
    fault that run_torch.sh's stage 0 repairs."""
    from wekws_tpu.data.processor import tokenize

    recipe = recipe_copy(tmp_path, "hi_xiaowen")
    local = os.path.join(recipe, "data", "local")
    write_layout("mobvoi", local, "--train", "8", "--dev", "4", "--test",
                 "4", "--ctc_data", os.path.join(recipe, "data_ctc"))
    res = os.path.join(local, "mobvoi_hotword_dataset_resources")
    for name, dict_text in (("ids", "-1 -1\n0 0\n1 1\n"),
                            ("names", "<FILLER> -1\n<HI_XIAOWEN> 0\n"
                                      "<NIHAO_WENWEN> 1\n")):
        dict_file = os.path.join(recipe, f"dict_{name}.txt")
        with open(dict_file, "w") as f:
            f.write(dict_text)
        for split, n in (("train", 8), ("dev", 4), ("test", 4)):
            out = os.path.join(recipe, name, split)
            prepare(recipe, os.path.join(local, "mobvoi_hotword_dataset"),
                    res, dict_file, split, out)
            want = {}
            for prefix in ("p", "n"):
                with open(os.path.join(res, f"{prefix}_{split}.json")) as f:
                    for e in json.load(f):
                        assert (e["keyword_id"] >= 0) == (prefix == "p")
                        want[e["utt_id"]] = e["keyword_id"]
            assert sorted(want.values()) == sorted([0, 1, -1, -1] * (n // 4))
            texts = table(os.path.join(out, "text"))
            labels = {k: s["label"] for k, s in zip(
                (k for k, _ in texts),
                tokenize([{"txt": t} for _, t in texts], None))}
            if name == "ids":
                assert labels == want
            else:
                assert set(labels.values()) == {-1}
            for key, path in table(os.path.join(out, "wav.scp")):
                assert path.endswith(f"mobvoi_hotword_dataset/{key}.wav")
            # the character transcripts (--ctc_data) name the same wavs
            ctc = dict(table(os.path.join(recipe, "data_ctc", split,
                                          "text")))
            for key, kid in want.items():
                if kid >= 0:
                    assert public_layouts.MOBVOI_KEYWORDS[kid] in ctc[key]
                else:
                    assert not any(k in ctc[key]
                                   for k in public_layouts.MOBVOI_KEYWORDS)


def test_speech_commands_layout_reads_through_prepare_data(tmp_path):
    """The split follows validation_list.txt and testing_list.txt; the
    10 commands are labels 0-9, other words 10, background noise 11."""
    recipe = recipe_copy(tmp_path, "speechcommand_v1")
    local = os.path.join(recipe, "data", "local")
    write_layout("speech_commands", local, "--train", "3", "--dev", "2",
                 "--test", "1")
    words = public_layouts.COMMANDS + public_layouts.OTHER_WORDS
    assert sorted(os.listdir(local)) == sorted(
        list(words) + ["_background_noise_", "validation_list.txt",
                       "testing_list.txt"])
    out = prepare(recipe, local, "data")
    n_words = len(words)
    noise = public_layouts.NOISE_FILES
    assert out.split("\n")[:3] == [f"train: {3 * n_words + noise} utts",
                                   f"valid: {2 * n_words} utts",
                                   f"test: {n_words} utts"]
    listed = {}
    for split, name in (("valid", "validation_list.txt"),
                        ("test", "testing_list.txt")):
        with open(os.path.join(local, name)) as f:
            listed[split] = {line.strip() for line in f}
    for split in ("train", "valid", "test"):
        wavs = dict(table(os.path.join(recipe, "data", split, "wav.scp")))
        for key, label in table(os.path.join(recipe, "data", split, "text")):
            word, name = os.path.relpath(wavs[key], local).split(os.sep)
            rel = f"{word}/{name}"
            assert (split == "valid") == (rel in listed["valid"])
            assert (split == "test") == (rel in listed["test"])
            want = (words.index(word) if word in public_layouts.COMMANDS
                    else 11 if word == "_background_noise_" else 10)
            assert int(label) == want


def test_layouts_are_seeded(tmp_path):
    """One seed writes the same bytes; another seed other audio."""
    dirs = []
    for i, seed in enumerate((SEED, SEED, SEED + 1)):
        out = str(tmp_path / str(i))
        public_layouts.main(["snips", out, "--train", "2", "--dev", "1",
                             "--test", "1", "--seed", str(seed)])
        dirs.append(out)
    a, b, c = (sorted(glob.glob(os.path.join(d, "**", "*.*"),
                                recursive=True)) for d in dirs)
    assert [os.path.relpath(p, dirs[0]) for p in a] == \
        [os.path.relpath(p, dirs[1]) for p in b]
    assert all(filecmp.cmp(x, y, shallow=False) for x, y in zip(a, b))
    assert not filecmp.cmp(a[0], c[0], shallow=False)


@pytest.mark.parametrize("conf", CONFIGS)
def test_conf_torch_is_conf_with_the_port_knobs(conf):
    recipe, _, name = conf.split(os.sep)
    with open(os.path.join(REPO, "examples", conf)) as f:
        got = yaml.safe_load(f)
    with open(os.path.join(REPO, "examples", recipe, "conf", name)) as f:
        want = yaml.safe_load(f)
    assert got["dataset_conf"].pop("fused_frontend") is True
    backbone = got["model"]["backbone"]
    if backbone["type"] == "mdtc":
        assert backbone.pop("fused_train") is True
    assert "fused_train" not in backbone
    assert got == want


@pytest.mark.parametrize("conf", CONFIGS)
def test_conf_torch_builds_in_the_port(conf):
    """The model through ``init_model`` at the width its recipe's
    ``bin.train`` gives it and the train and cv feature pipelines through
    ``DeviceFeaturePipeline.from_conf`` (the fused frontend); every block
    of an MDTC takes the fused passes."""
    with open(os.path.join(REPO, "examples", conf)) as f:
        configs = yaml.safe_load(f)
    train = DeviceFeaturePipeline.from_conf(configs["dataset_conf"], True)
    cv = DeviceFeaturePipeline.from_conf(configs["dataset_conf"], False)
    assert train.extractor.use_fused and cv.extractor.use_fused
    assert cv.extractor.cfg.dither == 0.0
    model_conf = copy.deepcopy(configs["model"])
    model_conf["input_dim"] = train.output_dim
    criterion = configs["training_config"].get("criterion")
    # local/prepare_ctc_dict.py's 7 tokens; 12 classes; 2 keywords; 1
    model_conf["output_dim"] = (
        7 if criterion == "ctc" else 12 if "speechcommand" in conf
        else 2 if "hi_xiaowen" in conf else 1)
    model = init_model(model_conf, torch.Generator().manual_seed(0))
    x = torch.randn(2, 30, train.output_dim)
    with torch.no_grad():
        y, _ = model(x)
    assert y.shape[0] == 2 and y.shape[-1] == model_conf["output_dim"]
    fused = [m.fused_train for m in model.modules()
             if hasattr(m, "fused_train")]
    backbone = configs["model"]["backbone"]
    if backbone["type"] == "mdtc":
        blocks = backbone["num_stack"] * backbone["stack_size"] + 1
        assert fused == [True] * blocks
    else:
        assert not any(fused)


def test_checkpoint_info_through_the_final_link(tmp_path):
    """``final.pt`` links ``<epoch>.pt``; its sidecar is ``<epoch>.yaml``
    (no ``final.yaml`` is written), so resuming from ``final.pt`` reads
    the last epoch's {epoch, lr, cv_loss}."""
    state = {"w": torch.zeros(2)}
    for epoch, lr, loss in ((0, 1e-3, 2.5), (1, 5e-4, 1.25)):
        save_checkpoint(str(tmp_path / f"{epoch}.pt"), state,
                        {"epoch": epoch, "lr": lr, "cv_loss": loss})
    link_final(str(tmp_path), 1)
    assert not os.path.exists(tmp_path / "final.yaml")
    assert load_checkpoint_info(str(tmp_path / "final.pt")) == {
        "epoch": 1.0, "lr": 5e-4, "cv_loss": 1.25}
    assert load_checkpoint_info(str(tmp_path / "2.pt")) == {}


@pytest.fixture(scope="module")
def snips_run(tmp_path_factory):
    """examples/hey_snips/run_torch.sh stages 0-3 on the CPU, 1 epoch, on
    a snips layout (24/8/12 utterances), conf_torch/ds_tcn.yaml with
    its batch cut to 8."""
    tmp = tmp_path_factory.mktemp("hey_snips")
    recipe = recipe_copy(tmp, "hey_snips")
    write_layout("snips", os.path.join(recipe, "data", "local"),
                 "--train", "24", "--dev", "8", "--test", "12")
    conf = cut_config(recipe, "conf_torch/ds_tcn.yaml")
    proc = run_script(recipe, ["run_torch.sh", "--config", conf, "0", "3",
                               "cpu", "1"])
    return recipe, conf, proc, tmp


def test_hey_snips_stages_run(snips_run):
    recipe, _, proc, _ = snips_run
    assert stages_done(proc.stdout) == ["0", "1", "2", "3"]
    exp = os.path.join(recipe, "exp", "torch_ds_tcn_cut")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    assert len(epochs) == 1 and epochs[0]["batches"] == 3


def test_hey_snips_stages_0_1_match_jax(snips_run):
    recipe, conf, _, tmp = snips_run
    same_stage_1_as_jax(recipe, "data", ("train", "dev", "test"), conf, tmp)


def test_hey_snips_score_and_det(snips_run):
    recipe, _, _, _ = snips_run
    result = os.path.join(recipe, "exp", "torch_ds_tcn_cut",
                          "test_avg_30.pt")
    keys = [e["key"] for e in read_list(os.path.join(
        recipe, "data", "test", "data.list"))]
    with open(os.path.join(result, "score.txt")) as f:
        lines = [line.split() for line in f]
    assert len(lines) == len(keys) == 12
    assert sorted(line[0] for line in lines) == sorted(keys)
    assert all(line[1] == "0" and len(line) > 2 for line in lines)
    with open(os.path.join(result, "stats.0.txt")) as f:
        rows = [tuple(map(float, line.split())) for line in f]
    assert len(rows) > 50 and all(len(r) == 3 for r in rows)
