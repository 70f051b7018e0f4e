"""The port's reader of the JAX package's flax-msgpack checkpoints
(wekws_tpu_torch/train/checkpoint.py) against flax on the committed
DS-TCN fixture (examples/synthetic/exp/ds_tcn/), and the fixture scored
by the port against the JAX package's scoring forward on the CPU."""

import os

import flax.serialization
import jax
import numpy as np
import pytest
import yaml

from wekws_tpu.bin.common import load_test_setup as jax_load_test_setup
from wekws_tpu.bin.common import make_forward_fn as jax_make_forward_fn
from wekws_tpu.data import init_dataset as jax_init_dataset
from wekws_tpu_torch.bin.common import load_test_setup, make_forward_fn
from wekws_tpu_torch.data import init_dataset
from wekws_tpu_torch.device import resolve_device
from wekws_tpu_torch.train.checkpoint import (
    load_jax_checkpoint,
    msgpack_restore,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "examples", "synthetic", "exp", "ds_tcn")
DATA = os.path.join(REPO, "examples", "synthetic", "data")
N_UTTS = 32


def leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)


@pytest.mark.parametrize("name", ["init", "avg_5", "final"])
def test_decoder_equals_flax_bit_for_bit(name):
    with open(os.path.join(FIXTURE, f"{name}.ckpt"), "rb") as f:
        data = f.read()
    want, want_def = leaves(flax.serialization.msgpack_restore(data))
    got, got_def = leaves(msgpack_restore(data))
    assert got_def == want_def and len(got) > 40
    for (gp, g), (wp, w) in zip(got, want):
        assert gp == wp
        assert type(g) is type(w) and g.dtype == w.dtype
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), gp


def test_decoder_scalars_and_errors():
    tree = {"a": [1, -3, 2 ** 40, -(2 ** 40), 2.5, None, True, "x" * 300],
            "s": np.float32(3.5), "c": 1 + 2j,
            "e": np.zeros((0, 3), np.float16),
            "big": np.arange(70000, dtype=np.int64)}
    data = flax.serialization.msgpack_serialize(tree)
    got, want = msgpack_restore(data), flax.serialization.msgpack_restore(data)
    assert got["a"] == want["a"] and got["c"] == want["c"]
    assert type(got["s"]) is np.float32 and got["s"] == want["s"]
    for key in ("e", "big"):
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key])
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-5])
    with pytest.raises(ValueError, match="trailing"):
        msgpack_restore(data + b"\x00")
    chunked = flax.serialization.msgpack_serialize(
        {"w": {"__msgpack_chunked_array__": True, "chunks": {}, "shape": []}})
    with pytest.raises(ValueError, match="chunked"):
        msgpack_restore(chunked)


def test_load_jax_checkpoint_trees():
    params, stats = load_jax_checkpoint(os.path.join(FIXTURE, "avg_5.ckpt"))
    assert set(params) == {"backbone", "classifier", "preprocessing"}
    assert stats["backbone"]["block_0"]["dw_bn"]["mean"].shape == (48,)


@pytest.fixture(scope="module")
def fixture_setup(tmp_path_factory):
    """The fixture's config with its cmvn path pointed at this checkout
    (it pins an absolute path), and a 32-line test list."""
    root = tmp_path_factory.mktemp("fixture")
    with open(os.path.join(FIXTURE, "config.yaml")) as f:
        configs = yaml.safe_load(f)
    configs["model"]["cmvn"]["cmvn_file"] = os.path.join(DATA, "global_cmvn")
    config = root / "config.yaml"
    config.write_text(yaml.safe_dump(configs))
    lines = []
    for i in range(N_UTTS):
        path = os.path.join(DATA, "test", f"test_{i}.wav")
        lines.append('{"key": "test_%d", "txt": "%s", "wav": "%s"}'
                     % (i, "0" if i % 2 == 0 else "-1", path))
    data_list = root / "test.list"
    data_list.write_text("\n".join(lines) + "\n")
    return str(config), str(data_list)


def test_fixture_scores_match_jax(fixture_setup):
    """avg_5.ckpt through the decoder and state_dict_from_jax, scored by
    the port's bin/common forward (module route on the CPU), against the
    JAX package's bin/common forward: 1e-4 abs + 1e-4 rel per frame."""
    config, data_list = fixture_setup
    ckpt = os.path.join(FIXTURE, "avg_5.ckpt")
    _, jmodel, jvars, jpipe, jconf = jax_load_test_setup(config, ckpt, 16)
    jforward = jax_make_forward_fn(jmodel, jvars, jpipe)
    want = [jforward(b) for b in jax_init_dataset(
        data_list, jconf, split="test", rank=0, world_size=1)]
    dev = resolve_device("cpu")
    _, model, pipe, conf = load_test_setup(config, ckpt, 16, dev)
    forward = make_forward_fn(model, pipe, dev)
    got = [forward(b) for b in init_dataset(data_list, conf, split="test",
                                           rank=0, world_size=1)]
    assert len(got) == len(want) == N_UTTS // 16
    for (g, gl), (w, wl) in zip(got, want):
        assert np.array_equal(gl, wl)
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
