"""examples/synthetic_scale through the port: ``local/gen_data_torch.py``
writes ``local/gen_data.py``'s corpus byte for byte (at a cut count),
and ``conf_torch/mdtc.yaml`` is ``conf/mdtc.yaml`` with the port's two
knobs (the fused frontend and the fused training passes) and nothing
else changed; its model (bf16 with ``bn_dtype``) is served float32 by
both routes."""

import copy
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.ops.serving import build_fused_forward
from wekws_tpu_torch.runtime.keyword_spotter import load_serving_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "examples", "synthetic_scale")
CUT = ("--train_kw", "3", "--train_filler", "5", "--dev_kw", "1",
       "--dev_filler", "2", "--test_kw", "2", "--test_filler", "3")


def gen(script, out):
    """A generator run from its own temporary directory into ``out``/data,
    the counts cut."""
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, os.path.join(RECIPE, "local", script),
                    os.path.join(out, "data"), *CUT], cwd=out, env=env,
                   check=True, capture_output=True, timeout=120)
    return os.path.join(out, "data")


def load(path):
    with open(os.path.join(RECIPE, path)) as f:
        return yaml.safe_load(f)


def test_gen_data_torch_writes_gen_data_corpus(tmp_path):
    """The same lists (wav paths aside) and byte-equal 6 s wavs."""
    got = gen("gen_data_torch.py", str(tmp_path / "torch"))
    want = gen("gen_data.py", str(tmp_path / "jax"))
    for split, n in (("train", 8), ("dev", 3), ("test", 5)):
        lines = [[json.loads(x)
                  for x in open(os.path.join(d, f"{split}.list"))]
                 for d in (got, want)]
        assert len(lines[0]) == len(lines[1]) == n
        for g, w in zip(*lines):
            assert g["wav"] == w["wav"].replace(want, got)
            assert {k: v for k, v in g.items() if k != "wav"} == \
                {k: v for k, v in w.items() if k != "wav"}
            assert g["duration"] == 6.0
            assert filecmp.cmp(g["wav"], w["wav"], shallow=False)
        assert sum(g["txt"] == "0" for g in lines[0]) == int(
            CUT[CUT.index(f"--{split}_kw") + 1])


def test_conf_torch_is_conf_with_the_port_knobs():
    want = load("conf/mdtc.yaml")
    got = load("conf_torch/mdtc.yaml")
    assert got["dataset_conf"].pop("fused_frontend") is True
    assert got["model"]["backbone"].pop("fused_train") is True
    assert got == want


@pytest.mark.parametrize("conf", ["conf_torch/mdtc.yaml",
                                  "conf/fsmn_ctc.yaml"])
def test_recipe_configs_build_in_the_port(conf):
    """Each config the port's recipes train builds at its bf16 compute
    dtype (float32 parameters); the MDTC's blocks take the fused
    passes."""
    model_conf = copy.deepcopy(load(conf)["model"])
    model_conf.setdefault("input_dim", 40 if "mdtc" in conf else 200)
    model_conf.setdefault("output_dim", 1 if "mdtc" in conf else 6)
    model = init_model(model_conf)
    assert model_conf["dtype"] == "bfloat16"
    assert all(p.dtype == torch.float32 for p in model.parameters())
    fused = [m.fused_train for m in model.modules()
             if hasattr(m, "fused_train")]
    assert fused == ([True] * 17 if "mdtc" in conf else [])


def test_bn_dtype_model_is_served_float32(tmp_path, caplog):
    """A checkpoint of conf_torch/mdtc.yaml (``dtype`` and ``bn_dtype``
    bfloat16) loads for inference without either, logged: the module
    route is the fused route's float32 function (1e-4 abs + 1e-4 rel,
    the two routes' pin), where a bf16 ``bn_dtype`` kept at inference
    rounds every BatchNorm's output."""
    configs = load("conf_torch/mdtc.yaml")
    configs["model"].update(input_dim=40, output_dim=1)
    trained = init_model(configs["model"], torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, buf in trained.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    ckpt = tmp_path / "avg.pt"
    torch.save(trained.state_dict(), ckpt)
    with caplog.at_level("WARNING"):
        model = load_serving_model(configs, str(ckpt), 40, "cpu")
    assert "bn_dtype 'bfloat16' dropped" in caplog.text
    assert all(m.out_dtype is None for m in model.modules()
               if hasattr(m, "out_dtype"))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 120, 40)).astype(np.float32))
    lengths = torch.full((2,), 120)
    with torch.inference_mode():
        want = build_fused_forward(model, device="cpu")(x, lengths)
        got, _ = model(x, lengths=lengths)
    lo, hi = float(got.min()), float(got.max())
    assert hi - lo > 1e-2, (lo, hi)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
