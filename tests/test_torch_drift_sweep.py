"""``python -m wekws_tpu_torch.tools.drift_sweep`` against the JAX
package's ``tools/drift_sweep.py`` (loaded by path, unchanged): the
committed JAX CTC fixture at float32 on 8 utterances of a cut synthetic
CTC test list, at two thresholds.  The event-set divergence and the
both-detected counts equal JAX's, and each threshold's largest score
gap agrees with JAX's within 2e-3 (ROADMAP C.4's limit); the printed
lines keep JAX's form."""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from wekws_tpu_torch.data.audio import read_wav
from wekws_tpu_torch.tools import drift_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "examples", "synthetic_ctc")
FIXTURE = os.path.join(RECIPE, "exp", "fsmn_ctc")
GAP_TOL = 2e-3
LINE = re.compile(r"thr (\S+): divergent (\d+)/(\d+) \((\S+)%\), "
                  r"both-detected (\d+), max score gap (\S+)$")


@pytest.fixture(scope="module")
def argv(tmp_path_factory):
    """The fixture's config without ``dtype``, and a test list of 8
    utterances from ``local/gen_data_torch.py`` (run from its own
    directory: it writes dict/ there)."""
    root = tmp_path_factory.mktemp("drift")
    with open(os.path.join(FIXTURE, "config.yaml")) as f:
        configs = yaml.safe_load(f)
    del configs["model"]["dtype"]
    configs["model"]["cmvn"]["cmvn_file"] = os.path.join(RECIPE, "data",
                                                         "global_cmvn")
    (root / "config.yaml").write_text(yaml.safe_dump(configs))
    subprocess.run([sys.executable, os.path.join(RECIPE, "local",
                                                 "gen_data_torch.py"),
                    str(root / "data"), "--train", "1", "--dev", "1",
                    "--test", "8"], cwd=root, check=True,
                   env=dict(os.environ, PYTHONPATH=REPO),
                   capture_output=True, timeout=120)
    return ["--config", str(root / "config.yaml"), "--checkpoint",
            os.path.join(FIXTURE, "avg_5.ckpt"), "--token_file",
            os.path.join(RECIPE, "dict", "dict.txt"), "--keywords", "123",
            "--test_data", str(root / "data" / "test.list"),
            "--thresholds", "0.1", "0.5"]


def printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def test_drift_sweep_matches_jax(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_tool_drift_sweep", os.path.join(REPO, "tools", "drift_sweep.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)

    def jax_main(args):
        monkeypatch.setattr(sys, "argv", ["drift_sweep"] + args)
        jax_tool.main()

    got = printed(drift_sweep.main, argv + ["--device", "cpu"])
    want = printed(jax_main, argv)
    assert got[0] == want[0] == "8 utts, thresholds [0.1, 0.5]"
    assert len(got) == len(want) == 4
    both = 0
    for g, w in zip(got[1:3], want[1:3]):
        gm, wm = LINE.match(g), LINE.match(w)
        assert gm and wm, (g, w)
        assert gm.groups()[:5] == wm.groups()[:5]
        assert abs(float(gm[6]) - float(wm[6])) <= GAP_TOL
        both += int(gm[5])
    assert both > 0  # the gap compares scores
    assert got[3].startswith("SUMMARY: max event-set divergence ")
    assert got[3].split(",")[0] == want[3].split(",")[0]


def test_run_engine_events_per_utterance(argv):
    """Host and device decode on the port: the same utterances fire,
    with scores within the gap's limit."""
    args = drift_sweep.get_args(argv + ["--device", "cpu"])
    wavs = []
    with open(args.test_data) as f:
        for line in f:
            wave, _ = read_wav(json.loads(line)["wav"])
            wavs.append((np.clip(wave, -1, 1) * 32767).astype("<i2")
                        .tobytes())
    host = drift_sweep.run_engine(args, wavs, False, 0.1)
    dev = drift_sweep.run_engine(args, wavs, True, 0.1)
    assert [bool(host[i]) for i in range(8)] == [bool(dev[i])
                                                 for i in range(8)]
    for i in range(8):
        if host[i]:
            assert host[i][0]["keyword"] == dev[i][0]["keyword"] == "123"
            assert abs(host[i][0]["score"] - dev[i][0]["score"]) <= GAP_TOL


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_cuda_without_gpu_raises(argv):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drift_sweep.main(argv)
