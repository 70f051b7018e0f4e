"""The port's DET plots against the JAX package's on the same stats
files: ``bin/plot_det_curve`` and ``bin/compute_det_ctc --figure_file``
draw JAX's figure pixel for pixel; without matplotlib the plot raises
``ImportError`` naming the ``plot`` extra, after compute_det_ctc has
written its stats files (ROADMAP C.29)."""

import filecmp
import json
import os
import sys

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")

from matplotlib import image  # noqa: E402

from wekws_tpu.bin import compute_det_ctc as jax_det_ctc_cli  # noqa: E402
from wekws_tpu.bin import plot_det_curve as jax_plot_cli  # noqa: E402
from wekws_tpu_torch.bin import compute_det_ctc, plot_det_curve  # noqa: E402

KEYWORDS = "123,321"


def same_png(a, b):
    got, want = image.imread(str(a)), image.imread(str(b))
    assert got.shape == want.shape and got.shape[0] > 100
    np.testing.assert_array_equal(got, want)


def run_jax_cli(cli, argv, monkeypatch):
    """A JAX CLI's ``main()`` (it reads ``sys.argv``), under a fresh rc
    context so that neither figure sees the other's rcParams."""
    monkeypatch.setattr(sys, "argv", ["cli"] + argv)
    with matplotlib.rc_context():
        cli.main()


def stats_dir(tmp_path, keywords=("hey", "hello")):
    """``stats.<keyword>.txt`` files of seeded DET sweeps and the
    ``words.txt`` that names them (after the filler line)."""
    rng = np.random.default_rng(4)
    out = tmp_path / "stats"
    out.mkdir()
    for kw in keywords:
        fa = np.sort(rng.random(101) * 6.0)[::-1]
        frr = np.sort(rng.random(101) * 0.4)
        (out / f"stats.{kw}.txt").write_text("".join(
            f"{t / 100:.6f} {a:.6f} {r:.6f}\n"
            for t, (a, r) in enumerate(zip(fa, frr))))
    words = tmp_path / "words.txt"
    words.write_text("<filler> -1\n" + "".join(
        f"{kw} {i}\n" for i, kw in enumerate(keywords)))
    return str(out), str(words)


def ctc_inputs(tmp_path):
    """A label list (two keywords and fillers, one minute each) and a
    score file of seeded detections."""
    rng = np.random.default_rng(9)
    labels, scores = [], []
    for i in range(60):
        txt = ("123" if i % 3 == 0 else "321" if i % 3 == 1 else "44")
        key = f"utt{i:03d}"
        labels.append(json.dumps({"key": key, "txt": txt,
                                  "duration": 60.0}))
        if rng.random() < 0.7:
            kw = txt if txt != "44" else ("123", "321")[i % 2]
            scores.append(f"{key} detected {kw} {rng.random():.3f}")
        else:
            scores.append(f"{key} rejected")
    test = tmp_path / "test.list"
    test.write_text("\n".join(labels) + "\n")
    score = tmp_path / "score.txt"
    score.write_text("\n".join(scores) + "\n")
    return str(test), str(score)


def test_plot_det_curve_equals_jax(tmp_path, monkeypatch):
    stats, words = stats_dir(tmp_path)
    argv = ["--keywords_dict", words, "--stats_dir", stats]
    run_jax_cli(jax_plot_cli, argv + ["--figure_file",
                                      str(tmp_path / "jax.png")],
                monkeypatch)
    with matplotlib.rc_context():
        got = plot_det_curve.main(argv + ["--figure_file",
                                          str(tmp_path / "port.png")])
    assert got == str(tmp_path / "port.png")
    same_png(tmp_path / "port.png", tmp_path / "jax.png")


def test_compute_det_ctc_figure_equals_jax(tmp_path, monkeypatch):
    test, score = ctc_inputs(tmp_path)
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    argv = ["--test_data", test, "--keywords", KEYWORDS, "--score_file",
            score]
    run_jax_cli(jax_det_ctc_cli, argv + [
        "--stats_dir", str(tmp_path / "jax"), "--figure_file",
        str(tmp_path / "jax.png")], monkeypatch)
    with matplotlib.rc_context():
        files = compute_det_ctc.main(argv + [
            "--stats_dir", str(tmp_path / "port"), "--figure_file",
            str(tmp_path / "port.png"), "--device", "cpu"])
    assert [os.path.basename(f) for f in files] == ["stats.1_2_3.txt",
                                                    "stats.3_2_1.txt"]
    for f in files:
        assert filecmp.cmp(f, str(tmp_path / "jax" / os.path.basename(f)),
                           shallow=False)
    same_png(tmp_path / "port.png", tmp_path / "jax.png")


@pytest.mark.parametrize("entry", ["compute_det_ctc", "plot_det_curve"])
def test_plot_without_matplotlib_raises(entry, tmp_path, monkeypatch):
    """No matplotlib: ImportError naming the ``plot`` extra, nothing
    drawn in its place; compute_det_ctc's stats files are written
    first."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    figure = tmp_path / "det.png"
    if entry == "compute_det_ctc":
        test, score = ctc_inputs(tmp_path)
        with pytest.raises(ImportError, match="'plot' extra"):
            compute_det_ctc.main(["--test_data", test, "--keywords",
                                  KEYWORDS, "--score_file", score,
                                  "--figure_file", str(figure), "--device",
                                  "cpu"])
        for kw in ("1_2_3", "3_2_1"):
            assert (tmp_path / f"stats.{kw}.txt").stat().st_size > 0
    else:
        stats, words = stats_dir(tmp_path)
        with pytest.raises(ImportError, match="'plot' extra"):
            plot_det_curve.main(["--keywords_dict", words, "--stats_dir",
                                 stats, "--figure_file", str(figure)])
    assert not figure.exists()
