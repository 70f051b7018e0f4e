"""What the benchmark's processes may load, and how a run without a card
or without the program ends."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from kwsbench.harness import BANNED, ROOT

PY = sys.executable


def loaded_after(code: str) -> set:
    """Top-level names in ``sys.modules`` after ``code`` in a fresh
    interpreter at the checkout's root."""
    out = subprocess.run(
        [PY, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


RUN_MODULES = (
    "import kwsbench.run, kwsbench.harness, kwsbench.calibrate, "
    "kwsbench.layers, kwsbench.drivers.train_resident\n"
    "from wekws_tpu_torch.data.device_pipeline import "
    "DeviceFeaturePipeline\n"
    "from wekws_tpu_torch.data.resident import gather_rows\n"
    "from wekws_tpu_torch.train.steps import Trainer\n"
    "from kwsbench import harness\n"
    "import glob, os\n"
    "for p in glob.glob(os.path.join(harness.HERE, 'metrics', '*.py')):\n"
    "    harness.reader(os.path.basename(p)[:-3])\n")


def test_a_run_loads_no_jax():
    names = loaded_after(RUN_MODULES)
    assert "wekws_tpu_torch" in names
    assert not names & set(BANNED), names & set(BANNED)


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("import kwsbench.reference.models, "
                         "kwsbench.reference.frontend")
    assert not names & (set(BANNED) | {"wekws_tpu_torch"})


def test_banned_names_are_compared_whole():
    from kwsbench import harness

    assert "wekws_tpu_torch" not in harness.banned_modules()
    sys.modules["wekws_tpu.fake"] = sys.modules["json"]
    try:
        assert harness.banned_modules() == ["wekws_tpu"]
    finally:
        del sys.modules["wekws_tpu.fake"]


def test_no_card_no_result():
    """Here there is no card: the command exits non-zero with no result
    line and no fallback to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [PY, "kwsbench/run.py", "--workload", "train_ds_tcn_b512_6s", "--seed",
         "2147483905", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    (no program) exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "kwsbench"), tmp_path / "kwsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [PY, "kwsbench/run.py", "--workload", "train_ds_tcn_b512_6s",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert "correct" not in out.stdout
