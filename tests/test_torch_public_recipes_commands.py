"""The public recipes on the port, part 4:
``examples/speechcommand_v1/run_torch.sh`` runs every stage on the CPU
on a Speech Commands v1 layout (12 classes, MFCC 80 of 80, the MDTC's
``global`` head through the fused passes' plain versions): stages 0-1
against the JAX package's tools, the accuracy line of
``bin.compute_accuracy``."""

import json
import os
import re

import pytest
from public_recipes import (
    cut_config,
    recipe_copy,
    run_script,
    same_stage_1_as_jax,
    stages_done,
    write_layout,
)

# 13 word directories, 2 train files a word + 2 noise files, 1 valid and
# 1 test file a word
N_TRAIN, N_TEST = 13 * 2 + 2, 13


@pytest.fixture(scope="module")
def commands_run(tmp_path_factory):
    """Stages 0-3, 1 epoch, conf_torch/mdtc.yaml with its batch cut to 8."""
    tmp = tmp_path_factory.mktemp("speechcommand_v1")
    recipe = recipe_copy(tmp, "speechcommand_v1")
    write_layout("speech_commands", os.path.join(recipe, "data", "local"),
                 "--train", "2", "--dev", "1", "--test", "1")
    conf = cut_config(recipe, "conf_torch/mdtc.yaml")
    proc = run_script(recipe, ["run_torch.sh", "--config", conf, "0", "3",
                               "cpu", "1"])
    return recipe, conf, proc, tmp


def test_speechcommand_stages_run(commands_run):
    recipe, _, proc, _ = commands_run
    assert stages_done(proc.stdout) == ["0", "1", "2", "3"]
    assert f"train: {N_TRAIN} utts" in proc.stdout
    with open(os.path.join(recipe, "exp", "torch_mdtc_cut",
                           "metrics.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    assert len(epochs) == 1 and epochs[0]["batches"] == N_TRAIN // 8


def test_speechcommand_stages_0_1_match_jax(commands_run):
    recipe, conf, _, tmp = commands_run
    same_stage_1_as_jax(recipe, "data", ("train", "valid", "test"), conf,
                        tmp)


def test_speechcommand_accuracy_line(commands_run):
    """bin.compute_accuracy's line over every test utterance."""
    out = commands_run[2].stdout
    found = re.findall(r"^Accuracy: ([0-9.]+) \((\d+)/(\d+)\)$", out,
                       re.MULTILINE)
    assert len(found) == 1
    acc, right, total = found[0]
    assert int(total) == N_TEST and float(acc) == int(right) / N_TEST
