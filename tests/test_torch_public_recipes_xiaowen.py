"""The public recipes on the port, part 2:
``examples/hi_xiaowen/run_torch.sh`` (the max-pooling path) runs every
stage on the CPU on a Mobvoi hotword layout: stages 0-1 against the JAX
package's tools, the two keywords' labels reaching the data lists,
scores and DET per keyword with ``--window_shift``, the plot."""

import importlib.util
import json
import os

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


@pytest.fixture(scope="module")
def xiaowen_run(tmp_path_factory):
    """Stages 0-3 (1 epoch, conf_torch/ds_tcn.yaml with its batch cut to
    8, 24/8/12 utterances), then stage 4 (the plot) apart: it needs
    matplotlib."""
    tmp = tmp_path_factory.mktemp("hi_xiaowen")
    recipe = recipe_copy(tmp, "hi_xiaowen")
    write_layout("mobvoi", os.path.join(recipe, "data", "local"),
                 "--train", "24", "--dev", "8", "--test", str(N_TEST))
    conf = cut_config(recipe, "conf_torch/ds_tcn.yaml")
    proc = run_script(recipe, ["run_torch.sh", "--config", conf, "0", "3",
                               "cpu", "1"])
    return recipe, conf, proc, tmp


def test_hi_xiaowen_stages_run(xiaowen_run):
    recipe, _, proc, _ = xiaowen_run
    assert stages_done(proc.stdout) == ["0", "1", "2", "3"]
    with open(os.path.join(recipe, "exp", "torch_ds_tcn_cut",
                           "metrics.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    assert len(epochs) == 1 and epochs[0]["batches"] == 3


def test_hi_xiaowen_stages_0_1_match_jax(xiaowen_run):
    recipe, conf, _, tmp = xiaowen_run
    same_stage_1_as_jax(recipe, "data", ("train", "dev", "test"), conf, tmp)


def test_hi_xiaowen_labels_are_the_keyword_ids(xiaowen_run):
    """Stage 0's dict names each keyword by its id, so the data lists
    carry the labels 0, 1 and -1 that bin.train reads as classes."""
    recipe = xiaowen_run[0]
    with open(os.path.join(recipe, "dict", "words.txt")) as f:
        assert f.read().split() == ["-1", "0", "1"]
    for split, n in (("train", 24), ("dev", 8), ("test", N_TEST)):
        txt = [e["txt"] for e in read_list(os.path.join(
            recipe, "data", split, "data.list"))]
        assert sorted(txt) == sorted(["0", "1", "-1", "-1"] * (n // 4))


def test_hi_xiaowen_score_and_det_per_keyword(xiaowen_run):
    recipe = xiaowen_run[0]
    result = os.path.join(recipe, "exp", "torch_ds_tcn_cut",
                          "test_avg_30.pt")
    keys = sorted(e["key"] for e in read_list(os.path.join(
        recipe, "data", "test", "data.list")))
    with open(os.path.join(result, "score.txt")) as f:
        lines = [line.split() for line in f]
    for keyword in ("0", "1"):
        mine = [line for line in lines if line[1] == keyword]
        assert sorted(line[0] for line in mine) == keys
        assert all(len(line) > 2 for line in mine)
        with open(os.path.join(result, f"stats.{keyword}.txt")) as f:
            rows = [tuple(map(float, line.split())) for line in f]
        assert len(rows) > 50 and all(len(r) == 3 for r in rows)
    assert len(lines) == 2 * N_TEST


def test_hi_xiaowen_plot_stage(xiaowen_run):
    """Stage 4 draws the DET plot of both keywords where matplotlib is
    installed, else raises naming the 'plot' extra."""
    recipe = xiaowen_run[0]
    figure = os.path.join(recipe, "exp", "torch_ds_tcn_cut",
                          "test_avg_30.pt", "det.png")
    argv = ["run_torch.sh", "--config", xiaowen_run[1], "4", "4", "cpu"]
    if importlib.util.find_spec("matplotlib") is None:
        with pytest.raises(AssertionError, match="'plot' extra"):
            run_script(recipe, argv)
        return
    assert stages_done(run_script(recipe, argv).stdout) == ["4"]
    assert os.path.getsize(figure) > 1000
