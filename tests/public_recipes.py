"""Helpers of the public recipes' CPU tests (``tests/test_torch_public_
recipes*.py``): a recipe copied into a temporary tree, a miniature
corpus in its public layout (``wekws_tpu_torch.tools.public_layouts``),
its port script run with ``[device] cpu``, and stage 1's files held
against the JAX package's tools."""

import json
import os
import shutil
import subprocess

import numpy as np
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny corpora's batch: train drops a partial batch, so the
# configs' batch sizes (100-256) are cut to whole batches of these
# corpora
CPU_BATCH = 8
SEED = 20261018


def recipe_copy(tmp, name):
    """examples/``name`` (no data, no experiments) and
    tools/parse_options.sh under ``tmp``; returns the recipe directory."""
    root = os.path.join(str(tmp), "examples", name)
    shutil.copytree(os.path.join(REPO, "examples", name), root,
                    ignore=shutil.ignore_patterns("data", "exp", "dict",
                                                  "__pycache__"))
    os.makedirs(os.path.join(str(tmp), "tools"), exist_ok=True)
    shutil.copy(os.path.join(REPO, "tools", "parse_options.sh"),
                os.path.join(str(tmp), "tools"))
    return root


def write_layout(layout, out, *args):
    from wekws_tpu_torch.tools.public_layouts import main

    main([layout, out, "--seed", str(SEED), *args])


def cut_config(recipe, conf, batch_size=CPU_BATCH):
    """``conf`` (relative to ``recipe``) copied beside itself with its
    batch size cut; returns the copy's relative path."""
    with open(os.path.join(recipe, conf)) as f:
        configs = yaml.safe_load(f)
    configs["dataset_conf"]["batch_conf"]["batch_size"] = batch_size
    cut = conf.replace(".yaml", "_cut.yaml")
    with open(os.path.join(recipe, cut), "w") as f:
        yaml.safe_dump(configs, f, allow_unicode=True)
    return cut


def run_script(recipe, argv, timeout=300):
    """``bash argv`` in ``recipe`` with the repo on PYTHONPATH; fails
    with the script's output unless it exits 0.  Each of its processes
    computes on one thread: the test workers share the cores, and the
    tiny models gain nothing from more."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.run(["bash", *argv], cwd=recipe, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    return proc


def stages_done(out):
    """The stages whose ``stage N done`` line a script printed."""
    return [line.split()[1] for line in out.splitlines()
            if line.startswith("stage ") and " done in " in line]


def read_list(path):
    with open(path, encoding="utf8") as f:
        return [json.loads(line) for line in f]


def same_stage_1_as_jax(recipe, data, splits, config, tmp, cmvn=True):
    """``data``/<split>/{data.list, wav.dur} byte for byte, and (with
    ``cmvn``) ``data``/train/global_cmvn within 1e-9 rel (the pin of
    ``tests/test_torch_tools.py``), against the JAX
    package's ``make_list``, ``wav_durations`` and ``compute_cmvn_stats``
    called in this process on the same wav.scp and text."""
    from wekws_tpu.tools import compute_cmvn_stats, make_list, wav_durations
    from wekws_tpu.tools.cmvn_stats import wav_paths_from_scp

    for split in splits:
        d = os.path.join(recipe, data, split)
        out = os.path.join(str(tmp), f"jax_{split}")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(d, "wav.scp")) as f:
            wav_durations([line.strip().split(maxsplit=1) for line in f],
                          os.path.join(out, "wav.dur"))
        make_list(os.path.join(d, "wav.scp"), os.path.join(d, "text"),
                  os.path.join(out, "wav.dur"),
                  os.path.join(out, "data.list"))
        for name in ("wav.dur", "data.list"):
            with open(os.path.join(d, name), "rb") as g, \
                    open(os.path.join(out, name), "rb") as w:
                got, want = g.read(), w.read()
            assert got == want and len(got) > 0, (split, name)
    if not cmvn:
        return
    with open(os.path.join(recipe, config)) as f:
        conf = yaml.safe_load(f)["dataset_conf"]
    want = compute_cmvn_stats(
        wav_paths_from_scp(os.path.join(recipe, data, "train", "wav.scp")),
        conf)
    with open(os.path.join(recipe, data, "train", "global_cmvn")) as f:
        got = json.load(f)
    assert got["frame_num"] == want["frame_num"] > 0
    for key in ("mean_stat", "var_stat"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9)
