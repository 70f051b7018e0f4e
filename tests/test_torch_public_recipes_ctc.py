"""The public recipes on the port, part 3:
``examples/hi_xiaowen/run_ctc_torch.sh --trainbase true`` runs every
stage on the CPU on a Mobvoi hotword layout with its character
transcripts and an ASR base corpus: the CTC dict, stages 0-1 and 1b's
lists against the JAX package's tools, the base pretraining, the
fine-tune resumed from the base's ``final.pt`` at the next epoch with
its lr and best cv loss as the JAX package's ``bin.train`` reads them
(``wekws_tpu/bin/train.py:230-236``), ``score_ctc`` and
``stream_score_ctc`` with their DET, the export and its int8 copy."""

import json
import os
import re

import pytest
from public_recipes import (
    cut_config,
    read_list,
    recipe_copy,
    run_script,
    same_stage_1_as_jax,
    stages_done,
    write_layout,
)

N_TEST = 12
STATS = ("stats.嗨_小_问.txt", "stats.你_好_问_问.txt")


@pytest.fixture(scope="module")
def ctc_run(tmp_path_factory):
    """Stages 0-5 with --trainbase true, 1 epoch a training stage,
    conf_torch/ds_tcn_ctc.yaml and the base's ds_tcn_ctc_base.yaml with
    their batches cut to 8; 24/8/12 keyword-corpus utterances, 16/8
    base ones."""
    tmp = tmp_path_factory.mktemp("hi_xiaowen_ctc")
    recipe = recipe_copy(tmp, "hi_xiaowen")
    write_layout("mobvoi", os.path.join(recipe, "data", "local"),
                 "--train", "24", "--dev", "8", "--test", str(N_TEST),
                 "--ctc_data", os.path.join(recipe, "data"),
                 "--asr_base", os.path.join(recipe, "data", "asr_base"),
                 "--base_train", "16", "--base_dev", "8")
    conf = cut_config(recipe, "conf_torch/ds_tcn_ctc.yaml")
    base = cut_config(recipe, "conf_torch/ds_tcn_ctc_base.yaml")
    proc = run_script(recipe, [
        "run_ctc_torch.sh", "--config", conf, "--trainbase", "true",
        "--trainbase_config", base, "0", "5", "cpu", "1"])
    return recipe, conf, base, proc, tmp


def test_ctc_stages_run(ctc_run):
    recipe, _, _, proc, _ = ctc_run
    assert stages_done(proc.stdout) == ["0", "1", "1b", "2", "3", "4", "5"]
    with open(os.path.join(recipe, "dict", "dict.txt"),
              encoding="utf-8") as f:
        assert f.read().split()[::2] == ["<blank>", "嗨", "小", "问", "你",
                                         "好", "<filler>"]
    for exp, epoch in (("torch_ctc_base", 0), ("torch_ds_tcn_ctc_cut", 1)):
        with open(os.path.join(recipe, "exp", exp, "metrics.jsonl")) as f:
            epochs = [json.loads(line) for line in f]
        assert [e["epoch"] for e in epochs] == [epoch]
        assert epochs[0]["batches"] == (2 if exp == "torch_ctc_base" else 3)


def test_ctc_stages_0_1_match_jax(ctc_run):
    recipe, conf, _, _, tmp = ctc_run
    same_stage_1_as_jax(recipe, "data", ("train", "dev", "test"), conf, tmp)


def test_ctc_base_lists_match_jax(ctc_run):
    """Stage 1b's lists of the ASR base corpus (the CMVN is stage 1's)."""
    recipe, conf, _, _, tmp = ctc_run
    same_stage_1_as_jax(recipe, os.path.join("data", "asr_base"),
                        ("train", "dev"), conf, tmp / "base", cmvn=False)


def test_fine_tune_resumes_from_the_base(ctc_run):
    """The fine-tune's first checkpoint is numbered one past the base's
    last; it starts from the lr and best cv loss of the checkpoint that
    ``final.pt`` links, read by the JAX package's own reader."""
    from wekws_tpu.train import load_checkpoint_info

    recipe, _, _, proc, _ = ctc_run
    base = os.path.join(recipe, "exp", "torch_ctc_base")
    last = os.path.realpath(os.path.join(base, "final.pt"))
    assert os.path.basename(last) == "0.pt"
    info = load_checkpoint_info(last)
    start = int(info["epoch"]) + 1
    found = re.findall(r"resumed from (\S+) at epoch (\d+), lr (\S+), best "
                       r"cv loss (\S+)", proc.stderr)
    assert found == [(os.path.join("exp", "torch_ctc_base", "final.pt"),
                      str(start), repr(float(info["lr"])),
                      repr(float(info["cv_loss"])))]
    exp = os.path.join(recipe, "exp", "torch_ds_tcn_ctc_cut")
    assert sorted(f for f in os.listdir(exp) if f[0].isdigit()) == \
        [f"{start}.pt", f"{start}.yaml"]
    first = load_checkpoint_info(os.path.join(exp, f"{start}.pt"))
    assert first["epoch"] == start and first["lr"] == info["lr"]


def test_ctc_scores_and_det(ctc_run):
    """score_ctc and stream_score_ctc: a line per test utterance; DET
    stats of both keywords."""
    recipe = ctc_run[0]
    keys = sorted(e["key"] for e in read_list(os.path.join(
        recipe, "data", "test", "data.list")))
    exp = os.path.join(recipe, "exp", "torch_ds_tcn_ctc_cut")
    for sub in ("test_avg_30.pt", "stream_avg_30.pt"):
        with open(os.path.join(exp, sub, "score.txt"),
                  encoding="utf-8") as f:
            lines = [line.split() for line in f]
        assert sorted(line[0] for line in lines) == keys
        for name in STATS:
            with open(os.path.join(exp, sub, name)) as f:
                rows = [tuple(map(float, line.split())) for line in f]
            assert len(rows) > 100 and all(len(r) == 3 for r in rows)


def test_ctc_export_and_int8(ctc_run):
    recipe = ctc_run[0]
    exp = os.path.join(recipe, "exp", "torch_ds_tcn_ctc_cut")
    for sub in ("export", "export_int8"):
        names = set(os.listdir(os.path.join(exp, sub)))
        assert {"model.json", "model.txt", "weights.bin"} <= names
        with open(os.path.join(exp, sub, "model.json")) as f:
            assert json.load(f)
