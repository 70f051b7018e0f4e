"""The port's classification path (ROADMAP A.17) against the JAX
package on the CPU: ``accuracy_over_dataset``, the ``global`` and
``last`` heads after the fused backbone (``build_fused_forward``, its
plain version on CPU tensors), ``bin.common.make_forward_fn``'s route
for each backbone, ``bin.compute_accuracy`` against the JAX CLI on the
synthetic commands corpus (``local/gen_data_torch.py``, byte for byte
``local/gen_data.py``'s) with the committed JAX fixture
``examples/synthetic_commands/exp/mdtc_ce/avg_5.ckpt`` and with a GRU
model."""

import contextlib
import filecmp
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

import wekws_tpu.eval.accuracy as jax_accuracy
from wekws_tpu.bin import compute_accuracy as jax_compute_accuracy
from wekws_tpu.eval.accuracy import (
    accuracy_over_dataset as jax_accuracy_over_dataset,
)
from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.train import save_checkpoint as jax_save_checkpoint
from wekws_tpu_torch.bin import common, compute_accuracy
from wekws_tpu_torch.bin.common import forward_route, make_forward_fn
from wekws_tpu_torch.data import DeviceFeaturePipeline
from wekws_tpu_torch.eval import accuracy_over_dataset
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.ops import serving
from wekws_tpu_torch.ops.serving import build_fused_forward, build_fused_stream
from wekws_tpu_torch.tools.from_jax import model_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "examples", "synthetic_commands")
FIXTURE = os.path.join(RECIPE, "exp", "mdtc_ce")
CKPT = os.path.join(FIXTURE, "avg_5.ckpt")
# examples/synthetic_commands/README.md: the fixture's test accuracy on
# the TPU (bfloat16), 248 of the corpus's 256 test utterances.  The port
# at float32 reads the same count on the CPU, and its predictions equal
# the JAX package's at float32 on every utterance (0 flips).
README_CORRECT, TEST_UTTS, FIXTURE_FLIPS = 248, 256, 0
GRU_UTTS = 32  # the GRU model is scored on the first lines of test.list


def gen(script, out, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, os.path.join(RECIPE, "local", script),
                    out, *args], env=env, check=True, capture_output=True,
                   timeout=120)
    return out


def test_accuracy_over_dataset_matches_jax():
    """Fill rows (``valid`` 0) count toward neither total nor correct;
    a batch without ``valid`` counts every row."""
    rng = np.random.default_rng(0)
    batches = []
    for b, with_valid in ((5, True), (3, False), (4, True)):
        batch = {"keys": [f"u{i}" for i in range(b)],
                 "target": rng.integers(0, 3, b).astype(np.int32),
                 "logits": rng.standard_normal((b, 3)).astype(np.float32)}
        if with_valid:
            batch["valid"] = np.array([1] * (b - 2) + [0, 0], np.float32)
            batch["logits"][-1, batch["target"][-1]] = 9.0  # a fill "hit"
        batches.append(batch)

    def forward(batch):
        return batch["logits"], None

    got = accuracy_over_dataset(forward, batches)
    assert got == jax_accuracy_over_dataset(forward, batches)
    assert got[1] == 3 + 3 + 2


def _mdtc_conf(head):
    return {"input_dim": 20, "output_dim": 5, "hidden_dim": 32,
            "preprocessing": {"type": "linear"},
            "backbone": {"type": "mdtc", "num_stack": 2, "stack_size": 2,
                         "kernel_size": 5, "hidden_dim": 32,
                         "causal": True},
            "classifier": {"type": head, "dropout": 0.3},
            "cmvn": {"mean": np.linspace(-1, 1, 20).tolist(),
                     "istd": np.linspace(0.5, 2, 20).tolist(),
                     "norm_var": True}}


@pytest.mark.parametrize("head", ["global", "last"])
def test_pooled_heads_after_fused_backbone(rng, head):
    """``build_fused_forward(device="cpu")`` (the MDTC kernel's plain
    version, then the head's pooling and MLP) against the module forward
    and flax's ``model.apply`` on ragged lengths, a length of 0 among
    them: logits (B, K) within 1e-5 abs + 1e-5 rel.  The kernel's
    outputs at padded frames are not zero, so pooling without the
    lengths would differ.  A pooled head has no streaming form."""
    conf = _mdtc_conf(head)
    jmodel = jax_init_model(conf)
    x = rng.standard_normal((5, 30, 20)).astype(np.float32)
    lengths = np.array([30, 21, 7, 1, 0], np.int32)
    variables = jmodel.init(jax.random.PRNGKey(1), x)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * np.arange(a.size, dtype=np.float32)
        .reshape(a.shape) / max(a.size, 1), variables["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    want, _ = jmodel.apply({"params": params, "batch_stats": stats}, x,
                           lengths=lengths)
    model = model_from_jax(params, stats, conf)
    fused = build_fused_forward(model, device="cpu")
    got = fused(torch.from_numpy(x), torch.from_numpy(lengths))
    with torch.inference_mode():
        module, _ = model(torch.from_numpy(x),
                          lengths=torch.from_numpy(lengths))
    assert got.shape == (5, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), module.numpy(), atol=1e-5,
                               rtol=1e-5)
    unmasked = fused(torch.from_numpy(x), None)
    assert not np.allclose(unmasked[:4].numpy(), got[:4].numpy(), atol=1e-3)
    assert build_fused_stream(model, device="cpu") is None


ROUTE_CONFS = {
    "mdtc": ("fused", _mdtc_conf("global")),
    "ds_tcn": ("fused", {"input_dim": 20, "output_dim": 2, "hidden_dim": 32,
                         "preprocessing": {"type": "linear"},
                         "backbone": {"type": "tcn", "ds": True,
                                      "num_layers": 2, "kernel_size": 3}}),
    "fsmn": ("fused", {"input_dim": 20, "output_dim": 4, "hidden_dim": 16,
                       "preprocessing": {"type": "none"},
                       "backbone": {"type": "fsmn", "input_affine_dim": 16,
                                    "num_layers": 2, "linear_dim": 16,
                                    "proj_dim": 32, "left_order": 3,
                                    "right_order": 1, "left_stride": 1,
                                    "right_stride": 1,
                                    "output_affine_dim": 16},
                       "classifier": {"type": "identity"},
                       "activation": {"type": "identity"}}),
    "gru": ("module", {"input_dim": 20, "output_dim": 4, "hidden_dim": 16,
                       "preprocessing": {"type": "linear"},
                       "backbone": {"type": "gru", "num_layers": 2},
                       "classifier": {"type": "global"}}),
    "tcn": ("module", {"input_dim": 20, "output_dim": 2, "hidden_dim": 32,
                       "preprocessing": {"type": "linear"},
                       "backbone": {"type": "tcn", "ds": False,
                                    "num_layers": 2, "kernel_size": 3}}),
    "mdtc_cnn1d_s1": ("fused", dict(_mdtc_conf("global"),
                                    preprocessing={"type": "cnn1d_s1"})),
}


@pytest.mark.parametrize("kind", sorted(ROUTE_CONFS))
def test_make_forward_fn_route_by_model(monkeypatch, kind):
    """On the card the route comes from the backbone: ``fused`` for MDTC,
    DS-TCN and FSMN (a model of these the builder cannot cover, MDTC
    after ``cnn1d_s1``, raises), ``module`` for GRU and full-conv TCN;
    on the CPU every model takes the module route.  The card is mocked:
    the builder runs with device="cpu" and the module route is never
    called."""
    want, conf = ROUTE_CONFS[kind]
    model = init_model(conf)
    pipe = DeviceFeaturePipeline.from_conf(
        {"feats_type": "fbank", "fbank_conf": {"num_mel_bins": 20}},
        training=False)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert make_forward_fn(model, pipe, cpu).route == "module"
    assert forward_route(model, cuda) == want
    built = []

    def on_cpu(model, softmax=False, device=None):
        built.append(device)
        return build_fused_forward(model, softmax=softmax, device="cpu")

    monkeypatch.setattr(common, "build_fused_forward", on_cpu)
    if kind == "mdtc_cnn1d_s1":
        with pytest.raises(NotImplementedError, match="Conv1dSubsampling1"):
            make_forward_fn(model, pipe, cuda)
    else:
        assert make_forward_fn(model, pipe, cuda).route == want
    assert built == ([cuda] if want == "fused" else [])
    assert serving.has_serving_kernel(model) == (want == "fused")


def _jax_cli(argv, capture):
    """The JAX package's compute_accuracy CLI: its printed line, and the
    outputs of its forward per batch."""
    outputs = []

    def recording(forward, dataset):
        def kept(batch):
            outputs.append(forward(batch))
            return outputs[-1]
        return jax_accuracy_over_dataset(kept, dataset)

    capture.setattr(jax_accuracy, "accuracy_over_dataset", recording)
    capture.setattr(sys, "argv", ["compute_accuracy"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_compute_accuracy.main()
    return out.getvalue().strip().splitlines()[-1], outputs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus (seed 11) from gen_data_torch.py; the fixture's config
    with its cmvn path pointed at this checkout, as written (bfloat16)
    and without ``dtype`` for the JAX reference at float32; a GRU CE
    model (gru_ce.yaml's shape, seeded weights) as a JAX ``.ckpt``; and
    the JAX CLI's lines and outputs on both."""
    root = tmp_path_factory.mktemp("commands")
    data = gen("gen_data_torch.py", str(root / "data"))
    with open(os.path.join(FIXTURE, "config.yaml")) as f:
        configs = yaml.safe_load(f)
    assert configs["model"]["dtype"] == "bfloat16"
    configs["model"]["cmvn"]["cmvn_file"] = os.path.join(RECIPE, "data",
                                                         "global_cmvn")
    out = {"data": data, "config": str(root / "config.yaml"),
           "config_f32": str(root / "config_f32.yaml")}
    with open(out["config"], "w") as f:
        yaml.safe_dump(configs, f)
    del configs["model"]["dtype"]
    with open(out["config_f32"], "w") as f:
        yaml.safe_dump(configs, f)
    with open(os.path.join(RECIPE, "conf", "gru_ce.yaml")) as f:
        gru = yaml.safe_load(f)
    gru["model"].update(input_dim=40, output_dim=8,
                        cmvn=configs["model"]["cmvn"])
    out["gru_config"] = str(root / "gru.yaml")
    with open(out["gru_config"], "w") as f:
        yaml.safe_dump(gru, f)
    variables = jax_init_model(gru["model"]).init(
        jax.random.PRNGKey(3), np.zeros((1, 8, 40), np.float32))
    out["gru_ckpt"] = str(root / "gru.ckpt")
    jax_save_checkpoint(out["gru_ckpt"], variables["params"],
                        variables.get("batch_stats", {}))
    with open(os.path.join(data, "test.list")) as f:
        lines = f.readlines()
    out["gru_list"] = str(root / "gru_test.list")
    with open(out["gru_list"], "w") as f:
        f.writelines(lines[:GRU_UTTS])
    with pytest.MonkeyPatch.context() as mp:
        out["jax"] = _jax_cli(["--config", out["config_f32"], "--test_data",
                               os.path.join(data, "test.list"),
                               "--checkpoint", CKPT], mp)
        out["jax_gru"] = _jax_cli(["--config", out["gru_config"],
                                   "--test_data", out["gru_list"],
                                   "--checkpoint", out["gru_ckpt"]], mp)
    return out


def _port_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = compute_accuracy.main(argv + ["--device", "cpu"])
    return out.getvalue().strip().splitlines()[-1], result


def test_fixture_accuracy_matches_jax_and_readme(corpus, caplog):
    """avg_5.ckpt with its bfloat16 config (the dtype dropped, and
    logged) through the port's CLI on the CPU: the line the JAX CLI
    prints at float32, 248/256 as the README's TPU run; its logits
    within 1e-4 abs + 1e-4 rel of JAX's, FIXTURE_FLIPS predictions
    apart."""
    test = os.path.join(corpus["data"], "test.list")
    line, (correct, total) = _port_cli(["--config", corpus["config"],
                                        "--test_data", test, "--checkpoint",
                                        CKPT])
    want_line, want_out = corpus["jax"]
    assert "model.dtype 'bfloat16' dropped" in caplog.text
    assert line == want_line == (f"Accuracy: {README_CORRECT / TEST_UTTS:.6f}"
                                 f" ({README_CORRECT}/{TEST_UTTS})")
    assert (correct, total) == (README_CORRECT, TEST_UTTS)
    dev = torch.device("cpu")
    _, model, pipe, conf = common.load_test_setup(corpus["config"], CKPT,
                                                  256, dev)
    from wekws_tpu_torch.data import init_dataset

    forward = make_forward_fn(model, pipe, dev)
    got = [forward(b) for b in init_dataset(test, conf, split="test")]
    assert len(got) == len(want_out) == 1
    flips = 0
    for (g, gl), (w, wl) in zip(got, want_out):
        np.testing.assert_array_equal(gl, wl)
        assert g.shape == w.shape == (TEST_UTTS, 8)
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
        flips += int((g.argmax(-1) != w.argmax(-1)).sum())
    assert flips == FIXTURE_FLIPS


def test_gru_accuracy_matches_jax_cli(corpus):
    """A GRU + global head CE model (module route) from a JAX ``.ckpt``:
    the port's CLI prints the JAX CLI's line on GRU_UTTS utterances."""
    line, (_, total) = _port_cli(["--config", corpus["gru_config"],
                                  "--test_data", corpus["gru_list"],
                                  "--checkpoint", corpus["gru_ckpt"]])
    assert line == corpus["jax_gru"][0] and total == GRU_UTTS


def test_gen_data_torch_writes_gen_data_corpus(tmp_path):
    """The same lists (wav paths aside) and byte-equal wavs as the JAX
    package's generator."""
    args = ("--train", "6", "--dev", "4", "--test", "5")
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
