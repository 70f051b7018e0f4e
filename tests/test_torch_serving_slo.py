"""``python -m wekws_tpu_torch.tools.bench_serving_slo`` against the JAX
package's ``tools/bench_serving_slo.py`` (loaded by path, unchanged) on
the committed JAX CTC fixture at float32: the synthesized utterances
byte for byte, the detection lines (activation frames, latencies and
misses exactly, hit scores within 2e-4), the latency lines' keys and
step-bearing chunk counts, and ``--device cuda`` raising without a
GPU."""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from wekws_tpu_torch.tools import bench_serving_slo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "examples", "synthetic_ctc")
FIXTURE = os.path.join(RECIPE, "exp", "fsmn_ctc")
TOKENS = os.path.join(RECIPE, "dict", "dict.txt")
# the printed hit score has 4 decimals; float32 in another order may
# round it one step apart
SCORE_TOL = 2e-4


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_slo = load_jax_tool("bench_serving_slo")


@pytest.fixture(scope="module")
def argv(tmp_path_factory):
    """The fixture's config without ``dtype`` (the port's loaders drop
    it; the JAX reference runs float32 too), its CMVN in this checkout."""
    with open(os.path.join(FIXTURE, "config.yaml")) as f:
        configs = yaml.safe_load(f)
    del configs["model"]["dtype"]
    configs["model"]["cmvn"]["cmvn_file"] = os.path.join(RECIPE, "data",
                                                         "global_cmvn")
    path = tmp_path_factory.mktemp("slo") / "config.yaml"
    path.write_text(yaml.safe_dump(configs))
    return ["--config", str(path), "--checkpoint",
            os.path.join(FIXTURE, "avg_5.ckpt"), "--tokens", TOKENS]


def lines_of(main, monkeypatch=None, argv=None):
    """The JSON lines ``main`` prints: the port's called with ``argv``,
    JAX's (``monkeypatch`` given) through ``sys.argv``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if monkeypatch is None:
            main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["bench_serving_slo"] + argv)
            main()
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.mark.parametrize("seed", range(4))
def test_synth_keyword_utt_is_jax(seed):
    tones = {"1": 500.0, "2": 800.0, "3": 1150.0, "4": 1500.0}
    got = bench_serving_slo.synth_keyword_utt(
        np.random.default_rng(seed), tones, "123", 0.5 + 0.3 * seed, 4.0)
    want = jax_slo.synth_keyword_utt(
        np.random.default_rng(seed), tones, "123", 0.5 + 0.3 * seed, 4.0)
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1] == want[1]
    # the default --tones is the generator's table
    assert bench_serving_slo.get_args(["--config", "c", "--checkpoint", "x",
                                       "--tokens", "t"]).tones == \
        ",".join(f"{k}:{v:g}" for k, v in tones.items())


def test_detection_lines_equal_jax(argv, monkeypatch):
    extra = ["--mode", "detection", "--utts", "6", "--dump_tail", "3"]
    got = lines_of(bench_serving_slo.main,
                   argv=argv + extra + ["--device", "cpu"])
    want = lines_of(jax_slo.main, monkeypatch, argv + extra)
    assert [list(g) for g in got] == [list(w) for w in want]
    assert got[0]["bench"] == "detection_latency"
    assert got[0]["missed"] < 6  # a check with detections to compare
    assert got[0] == want[0]
    assert len(got) == 4
    for g, w in zip(got[1:], want[1:]):
        g, w = dict(g["tail"]), dict(w["tail"])
        assert abs(g.pop("hit_score") - w.pop("hit_score")) <= SCORE_TOL
        assert g == w


@pytest.mark.parametrize("modes", [[], ["--device_decode",
                                        "--device_frontend"]])
def test_latency_lines_match_jax(argv, monkeypatch, modes):
    extra = ["--mode", "latency", "--streams", "1", "4", "--iters", "6",
             "--warmup", "2"] + modes
    got = lines_of(bench_serving_slo.main,
                   argv=argv + extra + ["--device", "cpu"])
    want = lines_of(jax_slo.main, monkeypatch, argv + extra)
    assert len(got) == len(want) == 2
    counted = ("bench", "streams", "chunk_frames", "device_decode",
               "device_frontend", "chunks", "step_chunks")
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert {k: g[k] for k in counted} == {k: w[k] for k in counted}
        # frame skip 3 at 8-frame chunks: not every chunk runs a step
        assert 0 < g["step_chunks"] < g["chunks"]
        assert all(np.isfinite(v) and v > 0 for k, v in g.items()
                   if k.endswith("_ms") or k == "realtime_factor")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_cuda_without_gpu_raises(argv):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_serving_slo.main(argv + ["--mode", "detection", "--utts", "1"])
