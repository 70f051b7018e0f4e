"""``bin/export_model --format stablehlo`` in both packages on the CPU:
the JAX CLI's serialized StableHLO of the jitted cached step
(``jax.export``) and the port CLI's ``torch.export`` program of the
module route's cached step (``model.pt2``), from the same checkpoint,
stepped over the same three chunks from the initial cache.  Models:
the committed JAX DS-TCN and FSMN-CTC fixtures, and seeded narrow MDTC
(2 stacks x 2 blocks, 16 channels) and GRU models."""

import copy
import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from wekws_tpu.bin import export_model as jax_export_cli
from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.train import save_checkpoint
from wekws_tpu_torch.bin import export_model as export_cli
from wekws_tpu_torch.export.cached_step import (
    aten_op_counts,
    check_cached_step,
    export_cached_step,
    flat_tensors,
    load_cached_step,
)
from wekws_tpu_torch.models import init_model
from wekws_tpu_torch.models.kws_model import inference_model_conf
from wekws_tpu_torch.train.checkpoint import load_model_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 8
CHUNKS = 3
# port vs JAX: tests/test_torch_mdtc.py's pin
ATOL, RTOL = 2e-4, 1e-3
# the program vs the eager step it was traced from
SELF_TOL = 1e-5
FIXTURES = {
    "ds_tcn": ("examples/synthetic/exp/ds_tcn", "examples/synthetic"),
    "fsmn_ctc": ("examples/synthetic_ctc/exp/fsmn_ctc",
                 "examples/synthetic_ctc"),
}
DATASET_CONF = {"feats_type": "fbank", "fbank_conf": {
    "num_mel_bins": 20, "frame_shift": 10, "frame_length": 25}}
SEEDED = {
    "mdtc": {"input_dim": 20, "output_dim": 1, "hidden_dim": 16,
             "preprocessing": {"type": "linear"},
             "backbone": {"type": "mdtc", "num_stack": 2, "stack_size": 2,
                          "kernel_size": 5, "hidden_dim": 16,
                          "causal": True}},
    "gru": {"input_dim": 20, "output_dim": 2, "hidden_dim": 16,
            "preprocessing": {"type": "linear"},
            "backbone": {"type": "gru", "num_layers": 2}},
}


def seeded_checkpoint(name, tmp_path):
    """A JAX ``.ckpt`` of a seeded model (BN statistics nudged, so that
    eval BN is not the identity) and its config file."""
    conf = SEEDED[name]
    model = jax_init_model(conf)
    variables = model.init(jax.random.PRNGKey(3),
                           np.zeros((1, 8, conf["input_dim"]), np.float32))
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * np.arange(a.size, dtype=np.float32)
        .reshape(a.shape) / max(a.size, 1),
        variables.get("batch_stats", {}))
    ckpt = str(tmp_path / "seeded.ckpt")
    save_checkpoint(ckpt, variables["params"], stats)
    config = tmp_path / "config.yaml"
    config.write_text(yaml.dump({"dataset_conf": DATASET_CONF,
                                 "model": conf}))
    return str(config), ckpt


def fixture_checkpoint(name, tmp_path):
    """A committed JAX fixture's ``avg_5.ckpt`` and its config, the CMVN
    file found in this checkout."""
    fx, recipe = (os.path.join(REPO, p) for p in FIXTURES[name])
    with open(os.path.join(fx, "config.yaml")) as f:
        configs = yaml.safe_load(f)
    configs["model"]["cmvn"]["cmvn_file"] = os.path.join(recipe, "data",
                                                         "global_cmvn")
    config = tmp_path / "config.yaml"
    config.write_text(yaml.dump(configs))
    return str(config), os.path.join(fx, "avg_5.ckpt")


def jax_stablehlo(config, ckpt, out_dir, monkeypatch):
    """The JAX CLI (its ``main()`` reads ``sys.argv``), then its blob
    deserialized."""
    monkeypatch.setattr(sys, "argv", [
        "export_model", "--config", config, "--checkpoint", ckpt,
        "--output_dir", out_dir, "--format", "stablehlo", "--chunk_frames",
        str(CHUNK)])
    jax_export_cli.main()
    with open(os.path.join(out_dir, "model.stablehlo"), "rb") as f:
        return jax.export.deserialize(bytearray(f.read()))


def port_model(config, ckpt):
    with open(config) as f:
        conf = inference_model_conf(yaml.safe_load(f)["model"])
    model = init_model(conf)
    model.load_state_dict(load_model_state(ckpt, conf, model))
    return model.eval(), conf


@pytest.mark.parametrize("name", ["ds_tcn", "fsmn_ctc", "mdtc", "gru"])
def test_exported_step_matches_jax(name, tmp_path, monkeypatch):
    """Outputs and every cache tensor of the port's ``model.pt2``
    against JAX's ``model.stablehlo`` over three chunks carried from the
    initial cache (2e-4 abs + 1e-3 rel); the program against the eager
    step (1e-5); the output cache in the input cache's structure; a
    chunk of another length refused."""
    if name in FIXTURES:
        config, ckpt = fixture_checkpoint(name, tmp_path)
    else:
        config, ckpt = seeded_checkpoint(name, tmp_path)
    exported = jax_stablehlo(config, ckpt, str(tmp_path / "jax"),
                             monkeypatch)
    out = str(tmp_path / "port")
    err = export_cli.main(["--config", config, "--checkpoint", ckpt,
                           "--output_dir", out, "--format", "stablehlo",
                           "--chunk_frames", str(CHUNK), "--device", "cpu"])
    assert err < SELF_TOL
    step = load_cached_step(os.path.join(out, "model.pt2"), "cpu")
    model, conf = port_model(config, ckpt)
    jcache = jax_init_model(conf).init_cache(1)
    cache = eager_cache = model.init_cache(1)
    assert len(flat_tensors(cache)) == len(jax.tree_util.tree_leaves(jcache))

    x = np.random.default_rng(5).standard_normal(
        (1, CHUNKS * CHUNK, conf["input_dim"])).astype(np.float32)
    for s in range(0, x.shape[1], CHUNK):
        chunk = x[:, s:s + CHUNK]
        want, jcache = exported.call(chunk, jcache)
        with torch.no_grad():
            got, new_cache = step(torch.from_numpy(chunk), cache)
            eager, eager_cache = model(torch.from_numpy(chunk), eager_cache,
                                       softmax=False)
        # chunk k+1 takes chunk k's cache as it came back
        assert type(new_cache) is type(cache)
        cache = new_cache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(got.numpy(), eager.numpy(),
                                   atol=SELF_TOL, rtol=SELF_TOL)
        leaves = jax.tree_util.tree_leaves(jcache)
        for g, w, e in zip(flat_tensors(cache), leaves,
                           flat_tensors(eager_cache)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=RTOL)
            np.testing.assert_allclose(g.numpy(), e.numpy(), atol=SELF_TOL,
                                       rtol=SELF_TOL)
    with pytest.raises((AssertionError, RuntimeError)):
        step(torch.zeros((1, CHUNK + 1, conf["input_dim"])),
             model.init_cache(1))


def test_exported_step_traces_no_training_branch():
    """A ``fused_train`` + ``remat`` MDTC (its training forward runs the
    fused passes under checkpointing) and a ghost-BN one export their
    eval cached step as aten ops alone, BN by the running statistics (no
    group index or sums), each program equal to its eager step."""
    for knobs in ({"fused_train": True, "remat": True}, {"ghost_bn": 2}):
        conf = copy.deepcopy(SEEDED["mdtc"])
        conf["backbone"].update(knobs)
        model = init_model(conf)
        model.train()
        program = export_cached_step(model, CHUNK, "cpu")
        assert not model.training
        ops = aten_op_counts(program)
        assert ops and all(k.startswith("aten.") for k in ops)
        assert not [k for k in ops if k.startswith(
            ("aten.arange", "aten.index_add", "aten.sum", "aten.mean"))]
        assert check_cached_step(program.module(), model, CHUNK,
                                 "cpu") < SELF_TOL
