"""The port's CTC recipe path on the CPU against the JAX package:
the synthetic CTC corpus from ``local/gen_data_torch.py`` (byte for
byte ``local/gen_data.py``'s), the committed JAX fixture
``examples/synthetic_ctc/exp/fsmn_ctc/avg_5.ckpt`` (its config says
``dtype: bfloat16``, which the port's loaders drop) scored, decoded,
DET-evaluated and streamed by the port's CLIs against the JAX package
at float32 and against the committed TPU files, and ``bin.train
--dict``."""

import filecmp
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from wekws_tpu.bin import stream_score_ctc as jax_stream_score_ctc
from wekws_tpu.bin.common import load_test_setup as jax_load_test_setup
from wekws_tpu.bin.common import make_forward_fn as jax_make_forward_fn
from wekws_tpu.data import init_dataset as jax_init_dataset
from wekws_tpu.eval.det import write_stats_file as jax_write_stats_file
from wekws_tpu.eval.det_ctc import compute_det_ctc as jax_compute_det_ctc
from wekws_tpu.eval.det_ctc import (
    load_label_and_score_ctc as jax_load_label_and_score_ctc,
)
from wekws_tpu.eval.score_ctc import (
    build_keywords_token as jax_build_keywords_token,
)
from wekws_tpu.eval.score_ctc import (
    write_ctc_score_file as jax_write_ctc_score_file,
)
from wekws_tpu.runtime import KeyWordSpotter as JaxKeyWordSpotter
from wekws_tpu.text import CharTokenizer as JaxCharTokenizer
from wekws_tpu_torch.bin import compute_det_ctc, score_ctc, stream_score_ctc
from wekws_tpu_torch.bin import train
from wekws_tpu_torch.bin.common import load_test_setup, make_forward_fn
from wekws_tpu_torch.data import init_dataset
from wekws_tpu_torch.device import resolve_device
from wekws_tpu_torch.eval import compare_ctc_score_files, read_ctc_score_file
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.runtime import BatchMaxPoolSpotter, KeyWordSpotter
from wekws_tpu_torch.text import CharTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "examples", "synthetic_ctc")
FIXTURE = os.path.join(RECIPE, "exp", "fsmn_ctc")
CKPT = os.path.join(FIXTURE, "avg_5.ckpt")
DICT = os.path.join(RECIPE, "dict")
KEYWORD = "123"
# the first 16 lines of test.list (keyword and filler alternate): the
# JAX streaming engine's parity run, which takes about 0.25 s a line
N_STREAM = 16
# the port at float32 against the committed TPU files, which the JAX
# package wrote from a bfloat16 model: offline scores agree to the
# printed 3 decimals (read: 0 flipped decisions, largest error 0.0, the
# stats file byte-identical); streamed scores, taken at the first frame
# past the threshold, move with the posteriors (read: 0 flips, largest
# error 0.047 over 192 utterances)
FIXTURE_SCORE_TOL, FIXTURE_STREAM_TOL = 1e-3, 0.05


def gen(script, out, *args):
    """Run a corpus generator from ``out`` (it writes dict/ into its
    working directory) into ``out``/data."""
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, os.path.join(RECIPE, "local", script),
                    os.path.join(out, "data"), *args], cwd=out, env=env,
                   check=True, capture_output=True, timeout=120)
    return os.path.join(out, "data")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The full corpus (seed 17) from gen_data_torch.py, and the JAX
    fixture's config with its cmvn path pointed at this checkout, as
    written (bfloat16) and without ``dtype`` for the JAX package's
    float32 reference."""
    root = tmp_path_factory.mktemp("ctc")
    data = gen("gen_data_torch.py", str(root / "torch"))
    with open(os.path.join(FIXTURE, "config.yaml")) as f:
        configs = yaml.safe_load(f)
    assert configs["model"]["dtype"] == "bfloat16"
    configs["model"]["cmvn"]["cmvn_file"] = os.path.join(RECIPE, "data",
                                                         "global_cmvn")
    bf16 = root / "config.yaml"
    bf16.write_text(yaml.safe_dump(configs))
    del configs["model"]["dtype"]
    f32 = root / "config_f32.yaml"
    f32.write_text(yaml.safe_dump(configs))
    lines = open(os.path.join(data, "test.list")).readlines()
    stream_list = root / "stream.list"
    stream_list.write_text("".join(lines[:N_STREAM]))
    return {"root": root, "data": data, "config": str(bf16),
            "config_f32": str(f32), "stream_list": str(stream_list)}


@pytest.fixture(scope="module")
def scored(corpus):
    """The fixture through the port's bin.score_ctc (host decoder and
    --device_decode), bin.compute_det_ctc and bin.stream_score_ctc on
    the CPU, and through the JAX package's scoring at float32."""
    root, test = corpus["root"], os.path.join(corpus["data"], "test.list")
    out = {}
    for name, extra in (("port", []), ("port_dd", ["--device_decode"])):
        out[name] = str(root / f"{name}_score.txt")
        assert score_ctc.main([
            "--config", corpus["config"], "--test_data", test,
            "--checkpoint", CKPT, "--score_file", out[name], "--dict", DICT,
            "--keywords", KEYWORD, "--device", "cpu"] + extra) == 192
    os.makedirs(root / "port_stats")
    out["port_stats"], = compute_det_ctc.main([
        "--test_data", test, "--keywords", KEYWORD, "--score_file",
        out["port"], "--stats_dir", str(root / "port_stats"),
        "--device", "cpu"])
    out["port_stream"] = str(root / "port_stream.txt")
    assert stream_score_ctc.main([
        "--config", corpus["config"], "--checkpoint", CKPT, "--test_data",
        test, "--token_file", os.path.join(DICT, "dict.txt"), "--keywords",
        KEYWORD, "--score_file", out["port_stream"], "--threshold", "0.1",
        "--device", "cpu"]) == 192

    tokenizer = JaxCharTokenizer(os.path.join(DICT, "dict.txt"), None,
                                 unk="<filler>", split_with_space=True)
    kw_token, idxset = jax_build_keywords_token([KEYWORD], tokenizer)
    _, model, variables, pipe, conf = jax_load_test_setup(
        corpus["config_f32"], CKPT, 256)
    forward = jax_make_forward_fn(model, variables, pipe, softmax=True)
    out["jax_outputs"] = []

    def kept(batch):
        out["jax_outputs"].append(forward(batch))
        return out["jax_outputs"][-1]

    for name, dd in (("jax", False), ("jax_dd", True)):
        out[name] = str(root / f"{name}_score.txt")
        jax_write_ctc_score_file(
            kept, jax_init_dataset(test, conf, tokenizer, split="test",
                                   rank=0, world_size=1),
            kw_token, idxset, out[name], device_decode=dd)
    table = jax_load_label_and_score_ctc([KEYWORD], test, out["jax"])
    out["jax_stats"] = str(root / "jax_stats.txt")
    jax_write_stats_file(jax_compute_det_ctc(table["1 2 3"]),
                         out["jax_stats"])
    return out


def test_gen_data_torch_writes_gen_data_corpus(tmp_path):
    """The same lists (wav paths aside) and byte-equal wavs as the JAX
    package's generator, each run from its own temporary directory; the
    token table each writes there is the committed dict/dict.txt."""
    args = ("--train", "6", "--dev", "4", "--test", "4")
    got = gen("gen_data_torch.py", str(tmp_path / "torch"), *args)
    want = gen("gen_data.py", str(tmp_path / "jax"), *args)
    for split in ("train", "dev", "test"):
        lines = [[json.loads(x)
                  for x in open(os.path.join(d, f"{split}.list"))]
                 for d in (got, want)]
        assert len(lines[0]) == len(lines[1]) > 0
        for g, w in zip(*lines):
            assert g["wav"] == w["wav"].replace(want, got)
            assert {k: v for k, v in g.items() if k != "wav"} == \
                {k: v for k, v in w.items() if k != "wav"}
            assert filecmp.cmp(g["wav"], w["wav"], shallow=False)
    for d in ("torch", "jax"):
        assert filecmp.cmp(tmp_path / d / "dict" / "dict.txt",
                           os.path.join(DICT, "dict.txt"), shallow=False)


def test_fixture_posteriors_match_jax_at_float32(corpus, scored, caplog):
    """avg_5.ckpt with its bfloat16 config through the port's
    load_test_setup (the dtype dropped, and logged) and its scoring
    forward (module route on the CPU, softmax) against the JAX package's
    at float32 on the 192 test utterances: 1e-4 abs + 1e-4 rel."""
    test = os.path.join(corpus["data"], "test.list")
    dev = resolve_device("cpu")
    with caplog.at_level(logging.WARNING):
        _, model, pipe, conf = load_test_setup(corpus["config"], CKPT, 256,
                                               dev)
    assert "model.dtype 'bfloat16' dropped" in caplog.text
    forward = make_forward_fn(model, pipe, dev, softmax=True)
    got = [forward(b) for b in init_dataset(test, conf, split="test")]
    want = scored["jax_outputs"][:len(got)]
    assert len(got) == 1 and len(scored["jax_outputs"]) == 2
    for (g, gl), (w, wl) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        assert g.shape == w.shape and g.shape[-1] == 6
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_score_ctc_and_det_match_jax(scored):
    """bin.score_ctc against the JAX package's scoring at float32: the
    same decisions and keywords, scores within 2e-3 (the file prints
    three decimals), with the host decoder and with --device_decode;
    the device decoder agrees with the host decoder on this trained
    model; bin.compute_det_ctc's stats file byte-identical to JAX's."""
    for got, want in (("port", "jax"), ("port_dd", "jax_dd"),
                      ("port_dd", "port")):
        flips, err = compare_ctc_score_files(scored[got], scored[want])
        assert not flips and err <= 2e-3, (got, want, flips, err)
    assert filecmp.cmp(scored["port_stats"], scored["jax_stats"],
                       shallow=False)
    assert os.path.basename(scored["port_stats"]) == "stats.1_2_3.txt"


def test_fixture_against_committed_tpu_files(scored):
    """The port's float32 scores against the committed score.txt,
    stream_score.txt and stats.1_2_3.txt (a TPU run in bfloat16): no
    decision flips, scores within FIXTURE_SCORE_TOL offline and
    FIXTURE_STREAM_TOL streamed, the stats file byte-identical."""
    flips, err = compare_ctc_score_files(scored["port"],
                                         os.path.join(FIXTURE, "score.txt"))
    assert not flips and err <= FIXTURE_SCORE_TOL, (flips, err)
    flips, err = compare_ctc_score_files(
        scored["port_stream"], os.path.join(FIXTURE, "stream_score.txt"))
    assert not flips and err <= FIXTURE_STREAM_TOL, (flips, err)
    assert filecmp.cmp(scored["port_stats"],
                       os.path.join(FIXTURE, "stats.1_2_3.txt"),
                       shallow=False)


def test_stream_score_ctc_matches_jax(corpus, scored, tmp_path,
                                      monkeypatch):
    """bin.stream_score_ctc on the first N_STREAM test lines against the
    JAX package's at float32: the same decisions, scores within 2e-3."""
    want = tmp_path / "jax_stream.txt"
    monkeypatch.setattr(sys, "argv", [
        "stream_score_ctc", "--config", corpus["config_f32"],
        "--checkpoint", CKPT, "--test_data", corpus["stream_list"],
        "--token_file", os.path.join(DICT, "dict.txt"), "--keywords",
        KEYWORD, "--score_file", str(want), "--threshold", "0.1"])
    jax_stream_score_ctc.main()
    got = tmp_path / "port_stream.txt"
    with open(scored["port_stream"]) as f:
        got.write_text("".join(f.readlines()[:N_STREAM]))
    flips, err = compare_ctc_score_files(str(got), str(want))
    assert not flips and err <= 2e-3, (flips, err)
    assert sum(v[0] == "detected"
               for v in read_ctc_score_file(str(got)).values()) >= 4


def test_keyword_spotter_reads_jax_checkpoint(corpus, caplog):
    """KeyWordSpotter(device='cpu') loads avg_5.ckpt with the bfloat16
    config (the dtype dropped, and logged): its posteriors on one test
    wave, fed in 300 ms chunks, within 1e-4 abs + 1e-4 rel of the JAX
    package's spotter at float32."""
    from wekws_tpu_torch.data.audio import read_wav

    token = os.path.join(DICT, "dict.txt")
    with caplog.at_level(logging.WARNING):
        port = KeyWordSpotter(CKPT, corpus["config"], token, None, 0.1,
                              device="cpu")
    assert "model.dtype 'bfloat16' dropped" in caplog.text
    jax_spot = JaxKeyWordSpotter(CKPT, corpus["config_f32"], token, None,
                                 0.1)
    wav = json.loads(open(os.path.join(corpus["data"],
                                       "test.list")).readline())["wav"]
    wave, sr = read_wav(wav)
    pcm = (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()
    probs = {}
    for name, spot in (("port", port), ("jax", jax_spot)):
        spot.set_keywords(KEYWORD)
        outs, apply = [], spot._apply

        def capture(feats, cache, _apply=apply, _outs=outs):
            p, cache = _apply(feats, cache)
            _outs.append(np.asarray(p)[0])
            return p, cache

        spot._apply = capture
        for off in range(0, len(pcm), 2 * 4800):
            spot.forward(pcm[off:off + 2 * 4800])
        probs[name] = np.concatenate(outs)
    assert probs["port"].shape == probs["jax"].shape
    assert probs["port"].shape[0] >= 30
    np.testing.assert_allclose(probs["port"], probs["jax"], atol=1e-4,
                               rtol=1e-4)


def test_serving_loaders_drop_dtype_and_log(tmp_path, caplog):
    """BatchMaxPoolSpotter (through load_serving_model) builds the
    float32 model of a bfloat16 config and logs the drop; init_model,
    which training calls, builds the bf16-compute model (float32
    parameters, a float32 output)."""
    conf = {
        "dataset_conf": {"feats_type": "fbank", "fbank_conf": {
            "num_mel_bins": 23, "frame_shift": 10, "frame_length": 25}},
        "model": {
            "input_dim": 23, "output_dim": 1, "hidden_dim": 32,
            "dtype": "bfloat16", "preprocessing": {"type": "linear"},
            "backbone": {"type": "mdtc", "num_stack": 1, "stack_size": 2,
                         "kernel_size": 5, "hidden_dim": 32,
                         "causal": True},
        },
    }
    trained = init_model(conf["model"])
    assert all(p.dtype == torch.float32 for p in trained.parameters())
    out, _ = trained(torch.zeros((1, 9, 23)))
    assert out.dtype == torch.float32
    assert trained.backbone.preprocessor.conv1.conv.dtype == torch.bfloat16
    f32 = dict(conf["model"])
    del f32["dtype"]
    ckpt = tmp_path / "m.pt"
    torch.save(init_model(f32).state_dict(), ckpt)
    with caplog.at_level(logging.WARNING):
        spot = BatchMaxPoolSpotter(str(ckpt), conf, 0.5, num_streams=2,
                                   device="cpu")
    assert "model.dtype 'bfloat16' dropped" in caplog.text
    assert all(p.dtype == torch.float32 for p in spot.model.parameters())
    assert conf["model"]["dtype"] == "bfloat16"  # the caller's config


def test_bin_train_dict_tokenizes_and_trains(corpus, tmp_path):
    """bin.train --dict on conf_torch/fsmn_ctc.yaml, one epoch on the
    generated corpus: the output width is the vocabulary, the losses
    finite; the dev list's batches through the port's tokenizer carry
    the JAX package's targets."""
    data = corpus["data"]
    exp = tmp_path / "exp"
    train.main([
        "--config", os.path.join(RECIPE, "conf_torch", "fsmn_ctc.yaml"),
        "--train_data", os.path.join(data, "train.list"), "--cv_data",
        os.path.join(data, "dev.list"), "--model_dir", str(exp), "--dict",
        DICT, "--seed", "888", "--cmvn_file",
        os.path.join(RECIPE, "data", "global_cmvn"), "--norm_var",
        "--num_epochs", "1", "--device", "cpu"])
    with open(exp / "config.yaml") as f:
        assert yaml.safe_load(f)["model"]["output_dim"] == 6
    with open(exp / "metrics.jsonl") as f:
        record = json.loads(f.readline())
    with open(exp / "0.yaml") as f:
        cv_loss = float(yaml.safe_load(f)["cv_loss"])
    assert np.isfinite([record["train_loss"], cv_loss]).all()
    assert record["batches"] >= 15
    with open(os.path.join(RECIPE, "conf_torch", "fsmn_ctc.yaml")) as f:
        dconf = yaml.safe_load(f)["dataset_conf"]
    dev = os.path.join(data, "dev.list")
    got = list(init_dataset(dev, dconf, CharTokenizer(
        os.path.join(DICT, "dict.txt"), unk="<filler>"), split="cv"))
    want = list(jax_init_dataset(dev, dconf, JaxCharTokenizer(
        os.path.join(DICT, "dict.txt"), unk="<filler>"), split="cv",
        rank=0, world_size=1))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for key in ("keys", "target", "target_lengths", "valid"):
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(w[key]))
    assert (np.asarray(got[0]["target"])[:, 0] >= 2).all()
