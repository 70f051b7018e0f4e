"""``python -m wekws_tpu_torch.tools.gate_knobs`` against the JAX
package's ``tools/gate_knobs.py`` (loaded by path, unchanged): each
shared variant turns ``examples/synthetic/conf/ds_tcn.yaml`` into JAX's
dict; ``frontend_default`` (ROADMAP C.37) raises, naming
``fbank_conf.precision``; ``baseline`` and ``bf16`` train on a cut copy
of the recipe's corpus (24 + 8 utterances, 2 epochs, batches of 8) to
finite cv losses, and the table keeps JAX's layout."""

import contextlib
import copy
import importlib.util
import io
import json
import math
import os
import shutil
import sys

import pytest
import torch
import yaml

from wekws_tpu_torch.tools import gate_knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "examples", "synthetic")
CUT = {"train": 24, "dev": 8}
OVERRIDES = {"training_config": {"max_epoch": 2},
             "dataset_conf": {"batch_conf": {"batch_size": 8}}}

spec = importlib.util.spec_from_file_location(
    "jax_tool_gate_knobs", os.path.join(REPO, "tools", "gate_knobs.py"))
jax_gate = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax_gate)


def recipe_conf():
    with open(os.path.join(RECIPE, "conf", "ds_tcn.yaml")) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("name", list(gate_knobs.VARIANTS))
def test_variant_conf_is_jax(name):
    conf = recipe_conf()
    want = jax_gate.VARIANTS[name](copy.deepcopy(conf))
    assert gate_knobs.variant_conf(name, conf) == want
    assert conf == recipe_conf()  # the caller's dict is left as it was


def test_frontend_default_raises_naming_the_key():
    assert "frontend_default" in jax_gate.VARIANTS
    assert "frontend_default" not in gate_knobs.VARIANTS
    assert set(jax_gate.VARIANTS) - set(gate_knobs.VARIANTS) == {
        "frontend_default"}
    with pytest.raises(ValueError, match=r"fbank_conf\.precision"):
        gate_knobs.variant_conf("frontend_default", recipe_conf())
    # asked for by name on the command line: raised before any training
    with pytest.raises(ValueError, match=r"fbank_conf\.precision"):
        gate_knobs.main(["baseline", "frontend_default", "--device", "cpu"])


@pytest.fixture(scope="module")
def cut_recipe(tmp_path_factory):
    """The recipe's config, CMVN and the first CUT waves of each split."""
    root = tmp_path_factory.mktemp("gate") / "synthetic"
    os.makedirs(root / "conf")
    shutil.copy(os.path.join(RECIPE, "conf", "ds_tcn.yaml"), root / "conf")
    os.makedirs(root / "data")
    shutil.copy(os.path.join(RECIPE, "data", "global_cmvn"), root / "data")
    for split, n in CUT.items():
        os.makedirs(root / "data" / split)
        for i in range(n):
            shutil.copy(os.path.join(RECIPE, "data", split,
                                     f"{split}_{i}.wav"),
                        root / "data" / split)
    return root


def test_make_lists_label_as_run_torch(cut_recipe, tmp_path):
    lists = gate_knobs.make_lists(str(cut_recipe), str(tmp_path))
    for split, n in CUT.items():
        rows = [json.loads(line) for line in open(lists[split])]
        assert [r["key"] for r in rows] == [f"{split}_{i}" for i in range(n)]
        assert [r["txt"] for r in rows] == ["0", "-1"] * (n // 2)
        assert all(r["duration"] > 0 and os.path.exists(r["wav"])
                   for r in rows)


def test_baseline_and_bf16_train_and_tabulate(cut_recipe, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    results = {name: gate_knobs.run_variant(
        name, str(tmp_path / "gates"), recipe=str(cut_recipe),
        device="cpu", overrides=OVERRIDES) for name in ("baseline", "bf16")}
    for name, losses in results.items():
        assert len(losses) == 2 and all(math.isfinite(v) for v in losses), \
            (name, losses)
        with open(tmp_path / "gates" / name / "conf.yaml") as f:
            conf = yaml.safe_load(f)
        assert conf["training_config"]["max_epoch"] == 2
        assert conf["model"].get("dtype") == ("bfloat16" if name == "bf16"
                                              else None)
    # JAX's table, printed from the same losses by its own main()
    monkeypatch.setattr(jax_gate, "ensure_corpus", lambda: None)
    monkeypatch.setattr(jax_gate, "run_variant",
                        lambda name, out_root: results[name])
    monkeypatch.setattr(sys, "argv", ["gate_knobs", *results])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_gate.main()
    want = [line for line in buf.getvalue().splitlines()
            if not line.startswith("===")]
    assert gate_knobs.table_lines(results) == want
    assert len(want) == 3


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_cuda_without_gpu_raises():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gate_knobs.main(["baseline"])
