"""examples/synthetic_noisy's aug-vs-clean comparison on the port
(ROADMAP A.19): ``local/report_torch.py`` prints ``local/report.py``'s
table character for character, and ``run_torch.sh`` with no config runs
both of run.sh's configs (augmented and clean) through every stage on
the CPU and ends with that table; given one config it runs that config
alone."""

import contextlib
import importlib.util
import io
import os
import shutil
import sys

import numpy as np
import pytest
from public_recipes import REPO, recipe_copy, run_script

RECIPE = os.path.join(REPO, "examples", "synthetic_noisy")
# the cut corpus of the CPU run (full: 480/96/192, 40 noises, 12 RIRs):
# one batch of 64 an epoch
CUT = ("--train", "64", "--dev", "16", "--test", "24", "--noises", "4",
       "--rirs", "2")


def report_main(name):
    """``local/<name>.py``'s ``main``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"noisy_{name}", os.path.join(RECIPE, "local", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def printed(main, dirs):
    out = io.StringIO()
    argv = sys.argv
    sys.argv = ["report", *dirs]
    try:
        with contextlib.redirect_stdout(out):
            main()
    finally:
        sys.argv = argv
    return out.getvalue()


def write_stats(path, rng):
    """A DET sweep's rows (threshold, FA/h, FRR): FA falling and FRR
    rising with the threshold, from ``rng``."""
    th = np.round(np.arange(0.0, 1.0001, 0.01), 2)
    fa = np.sort(rng.exponential(3.0, th.size))[::-1]
    frr = np.sort(rng.random(th.size))
    with open(path, "w") as f:
        for row in zip(th, fa, frr):
            f.write("%.2f %.6f %.6f\n" % row)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_report_torch_prints_report_table(tmp_path, seed):
    rng = np.random.default_rng(seed)
    dirs = []
    for name in ("ds_tcn_aug", "torch_ds_tcn_clean", "m"):
        d = tmp_path / name
        d.mkdir()
        for split in ("test", "test_noisy"):
            write_stats(d / f"stats_{split}.txt", rng)
        dirs.append(str(d) + ("/" if name == "m" else ""))
    want = printed(report_main("report"), dirs)
    got = printed(report_main("report_torch"), dirs)
    assert got == want
    assert len(got.splitlines()) == 4


@pytest.fixture(scope="module")
def noisy_run(tmp_path_factory):
    """run_torch.sh 0 5 with no config (``all``), 1 epoch, on the cut
    corpus."""
    tmp = tmp_path_factory.mktemp("synthetic_noisy")
    recipe = recipe_copy(tmp, "synthetic_noisy")
    # local/gen_data_torch.py draws its waves with examples/synthetic's
    # generator
    shutil.copytree(os.path.join(REPO, "examples", "synthetic", "local"),
                    os.path.join(str(tmp), "examples", "synthetic", "local"))
    proc = run_script(recipe, ["run_torch.sh", "0", "5", "all", "cpu", "1",
                               *CUT], timeout=600)
    return recipe, proc


def test_both_configs_through_every_stage(noisy_run):
    recipe, _ = noisy_run
    for name in ("torch_ds_tcn_aug", "torch_ds_tcn_clean"):
        exp = os.path.join(recipe, "exp", name)
        assert os.path.isfile(os.path.join(exp, "avg_5.pt"))
        for split, n in (("test", 24), ("test_noisy", 24)):
            with open(os.path.join(exp, f"score_{split}.txt")) as f:
                assert len(f.readlines()) == n
            with open(os.path.join(exp, f"stats_{split}.txt")) as f:
                rows = [tuple(map(float, line.split())) for line in f]
            assert len(rows) > 50 and all(len(r) == 3 for r in rows)


def test_run_ends_with_the_report(noisy_run):
    """The table that run_torch.sh prints is report.py's over its two
    experiments."""
    recipe, proc = noisy_run
    dirs = [os.path.join(recipe, "exp", n)
            for n in ("torch_ds_tcn_aug", "torch_ds_tcn_clean")]
    want = printed(report_main("report"), dirs)
    assert proc.stdout.endswith(want)
    assert want.splitlines()[1].split()[0] == "torch_ds_tcn_aug"


def test_one_config_runs_alone(noisy_run):
    """Given one config, stage 5 runs DET for that experiment only and
    prints no table."""
    recipe, _ = noisy_run
    clean = os.path.join(recipe, "exp", "torch_ds_tcn_clean")
    aug = os.path.join(recipe, "exp", "torch_ds_tcn_aug")
    for d in (clean, aug):
        os.remove(os.path.join(d, "stats_test.txt"))
    proc = run_script(recipe, ["run_torch.sh", "5", "5",
                               "conf/ds_tcn_clean.yaml", "cpu"])
    assert os.path.isfile(os.path.join(clean, "stats_test.txt"))
    assert not os.path.exists(os.path.join(aug, "stats_test.txt"))
    assert "clean FRR" not in proc.stdout
