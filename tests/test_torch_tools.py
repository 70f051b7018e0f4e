"""The port's host tools (wekws_tpu_torch.tools: make_blob, shuffle_list,
cmvn_stats) against the JAX package's on the CPU: the same blob store
byte for byte, the same shuffled lines, the same CMVN statistics."""

import io
import json
import os
import sys

import numpy as np
import pytest

from wekws_tpu.frontend.cmvn import load_cmvn as jax_load_cmvn
from wekws_tpu.tools import cmvn_stats as jax_cmvn_stats
from wekws_tpu.tools import make_blob as jax_make_blob
from wekws_tpu.tools import shuffle_list as jax_shuffle_list
from wekws_tpu_torch.data.blobstore import BlobData
from wekws_tpu_torch.frontend.cmvn import load_cmvn
from wekws_tpu_torch.tools import compute_cmvn_stats, make_blob, shuffle_list
from wekws_tpu_torch.tools.cmvn_stats import (
    wav_paths_from_data_list,
    wav_paths_from_scp,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = os.path.join(REPO, "examples", "synthetic", "data", "dev")
N_DEV = 96


def dev_wavs(n=N_DEV):
    return [(f"dev_{i}", os.path.join(DEV, f"dev_{i}.wav")) for i in range(n)]


def test_make_blob_equals_jax(tmp_path):
    """The same scp packed by both tools (the port's through its CLI):
    identical .blob and .idx files, read back by the port's BlobData."""
    scp = tmp_path / "wav.scp"
    scp.write_text("".join(f"{k} {p}\n" for k, p in dev_wavs(12)) + "\n")
    make_blob.main([str(scp), str(tmp_path / "port")])
    assert jax_make_blob.make_blob(str(scp), str(tmp_path / "jax")) == 12
    for ext in (".blob", ".idx"):
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"jax{ext}").read_bytes()
    store = BlobData(str(tmp_path / "port"))
    assert [e[0] for e in store.entries] == [k for k, _ in dev_wavs(12)]
    for i, (key, path) in enumerate(dev_wavs(12)):
        with open(path, "rb") as f:
            assert store.get(i) == (key, f.read())
    bad = tmp_path / "bad.scp"
    bad.write_text("dev_0\n")
    with pytest.raises(ValueError, match="expected 'key path'"):
        make_blob.make_blob(str(bad), str(tmp_path / "bad"))


@pytest.mark.parametrize("seed", [777, 3])
def test_shuffle_list_equals_jax(tmp_path, capsys, monkeypatch, seed):
    src = tmp_path / "in.list"
    src.write_text("".join(f'{{"key": "u{i}"}}\n' for i in range(41)))
    monkeypatch.setattr(sys, "argv", ["shuffle_list", "--seed", str(seed),
                                      str(src)])
    jax_shuffle_list.main()
    want = capsys.readouterr().out
    shuffle_list.main(["--seed", str(seed), str(src)])
    assert capsys.readouterr().out == want
    assert sorted(want.splitlines()) == sorted(src.read_text().splitlines())
    monkeypatch.setattr(sys, "stdin", io.StringIO(src.read_text()))
    shuffle_list.main(["--seed", str(seed)])
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("conf", [
    {"feats_type": "fbank", "fbank_conf": {
        "num_mel_bins": 40, "frame_shift": 10, "frame_length": 25,
        "dither": 1.0}},
    {"feats_type": "mfcc", "mfcc_conf": {
        "num_mel_bins": 40, "num_ceps": 13, "frame_shift": 10,
        "frame_length": 25, "dither": 1.0}},
], ids=["fbank", "mfcc"])
def test_cmvn_stats_equals_jax(tmp_path, conf):
    """The committed dev wavs' statistics (dither forced to 0) within
    1e-9 rel of JAX's, the same frame count; the JSON loads through the
    port's CMVN reader as JAX's loads through its own."""
    scp = tmp_path / "wav.scp"
    scp.write_text("".join(f"{k} {p}\n" for k, p in dev_wavs()))
    lst = tmp_path / "dev.list"
    lst.write_text("".join(json.dumps({"key": k, "txt": "0", "wav": p})
                           + "\n" for k, p in dev_wavs()))
    paths = list(wav_paths_from_scp(str(scp)))
    assert paths == list(jax_cmvn_stats.wav_paths_from_scp(str(scp)))
    assert list(wav_paths_from_data_list(str(lst))) == paths == list(
        jax_cmvn_stats.wav_paths_from_data_list(str(lst)))
    out = tmp_path / "port_cmvn.json"
    got = compute_cmvn_stats(paths, conf, str(out))
    want = jax_cmvn_stats.compute_cmvn_stats(paths, conf,
                                             str(tmp_path / "jax_cmvn.json"))
    assert got["frame_num"] == want["frame_num"] > 0
    dim = 13 if "mfcc_conf" in conf else 40
    for key in ("mean_stat", "var_stat"):
        assert len(got[key]) == dim
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9)
    for g, w in zip(load_cmvn(str(out)),
                    jax_load_cmvn(str(tmp_path / "jax_cmvn.json"))):
        assert g.shape == (dim,)
        np.testing.assert_allclose(g, w, rtol=1e-9)
