"""The port's host data pipeline (wekws_tpu_torch.data, tools) against the
JAX package's on the CPU: audio I/O and transforms, the blob store, the
list tools, and the batches of ``init_dataset`` and ``DataLoader`` over
committed wavs of examples/synthetic, equal array for array.

Both packages seed and draw from the global ``random``, so each test
iterates the JAX pipeline to its end before the port's, never the two
interleaved."""

import json
import os
import pickle

import numpy as np
import pytest

from wekws_tpu.data import audio as jax_audio
from wekws_tpu.data import init_dataset as jax_init_dataset
from wekws_tpu.data.blobstore import BlobWriter
from wekws_tpu.data.loader import DataLoader as JaxDataLoader
from wekws_tpu.tools.durations import wav_durations as jax_wav_durations
from wekws_tpu.tools.make_list import make_list as jax_make_list
from wekws_tpu_torch.bin import make_list as make_list_cli
from wekws_tpu_torch.data import DataLoader, audio, init_dataset
from wekws_tpu_torch.data.blobstore import BlobData, open_store
from wekws_tpu_torch.tools.durations import wav_durations
from wekws_tpu_torch.tools.make_list import make_list

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVS = os.path.join(REPO, "examples", "synthetic", "data", "train")
N_LINES = 48
ARRAYS = ("waves", "wave_lengths", "target", "target_lengths", "valid")

BASE_CONF = {  # examples/synthetic/conf/mdtc.yaml's dataset_conf
    "filter_conf": {"max_length": 2048, "min_length": 0},
    "resample_conf": {"resample_rate": 16000},
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 40, "frame_shift": 10,
                   "frame_length": 25, "dither": 1.0},
    "spec_aug": True,
    "shuffle": True,
    "shuffle_conf": {"shuffle_size": 500},
    "batch_conf": {"batch_size": 8, "bucket_samples": 16000},
}


def conf_of(kind, stores):
    conf = json.loads(json.dumps(BASE_CONF))
    if kind == "buckets":  # lockstep schedule: fill rows in the short ones
        conf["batch_conf"] = {"batch_size": 8,
                              "bucket_boundaries": [24000, 32000]}
    elif kind == "aug":
        conf["speed_perturb"] = True
        conf.update(noise_prob=0.5, noise_source=stores["noise"],
                    reverb_prob=0.5, reverb_source=stores["rir"])
    return conf


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 48-line list of committed wavs (labels as gen_data.py gave
    them, durations), a noise and an RIR blob store written by the JAX
    package's BlobWriter."""
    root = tmp_path_factory.mktemp("corpus")
    lines = []
    for i in range(N_LINES):
        path = os.path.join(WAVS, f"train_{i}.wav")
        wave, sr = jax_audio.read_wav(path)
        lines.append(json.dumps({"key": f"train_{i}",
                                 "txt": "0" if i % 2 == 0 else "-1",
                                 "wav": path, "duration": len(wave) / sr}))
    data_list = root / "data.list"
    data_list.write_text("\n".join(lines) + "\n")
    rng = np.random.default_rng(0)
    stores = {"noise": str(root / "noise"), "rir": str(root / "rir")}
    with BlobWriter(stores["noise"]) as w:
        for i in range(3):
            p = root / f"noise_{i}.wav"
            jax_audio.write_wav(str(p), 0.1 * rng.standard_normal(
                12000 + 4000 * i).astype(np.float32), 16000)
            w.put(f"noise_{i}", p.read_bytes())
    with BlobWriter(stores["rir"]) as w:
        for i in range(2):
            p = root / f"rir_{i}.wav"
            decay = np.exp(-np.arange(800) / (60.0 + 40 * i))
            jax_audio.write_wav(str(p), (0.5 * decay * rng.standard_normal(
                800)).astype(np.float32), 16000)
            w.put(f"rir_{i}", p.read_bytes())
    return {"list": str(data_list), "stores": stores, "root": root}


def assert_batches_equal(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert g["keys"] == w["keys"]
        for name in ARRAYS:
            assert g[name].dtype == w[name].dtype, name
            assert np.array_equal(g[name], w[name]), name


def test_audio_matches_jax():
    path = os.path.join(WAVS, "train_3.wav")
    wave, sr = audio.read_wav(path)
    want, want_sr = jax_audio.read_wav(path)
    assert sr == want_sr and np.array_equal(wave, want)
    with open(path, "rb") as f:
        raw = f.read()
    assert np.array_equal(audio.read_wav(raw)[0], jax_audio.read_wav(raw)[0])
    for target in (8000, 22050):
        assert np.array_equal(audio.resample(wave, sr, target),
                              jax_audio.resample(want, sr, target))
    for speed in (0.9, 1.1):
        for method in ("linear", "poly"):
            assert np.array_equal(
                audio.speed_perturb(wave, speed, method),
                jax_audio.speed_perturb(want, speed, method))


def test_make_list_and_durations_match_jax(tmp_path):
    scp, text = tmp_path / "wav.scp", tmp_path / "text"
    scp.write_text("".join(f"train_{i} {WAVS}/train_{i}.wav\n"
                           for i in range(N_LINES)))
    text.write_text("".join(f"train_{i} {0 if i % 2 == 0 else -1}\n"
                            for i in range(N_LINES)))
    entries = [(f"train_{i}", f"{WAVS}/train_{i}.wav")
               for i in range(N_LINES)]
    assert wav_durations(entries, str(tmp_path / "dur")) == \
        jax_wav_durations(entries, str(tmp_path / "jax_dur"))
    assert (tmp_path / "dur").read_text() == \
        (tmp_path / "jax_dur").read_text()
    for dur in (str(tmp_path / "dur"), None):
        assert make_list(str(scp), str(text), dur, str(tmp_path / "a")) == \
            jax_make_list(str(scp), str(text), dur, str(tmp_path / "b"))
        assert (tmp_path / "a").read_text() == (tmp_path / "b").read_text()
    # the CLI writes the missing duration file first, then the same list
    assert make_list_cli.main([str(scp), str(text), str(tmp_path / "cli.dur"),
                               str(tmp_path / "cli.list")]) == N_LINES
    assert (tmp_path / "cli.dur").read_text() == (tmp_path / "dur").read_text()
    jax_make_list(str(scp), str(text), str(tmp_path / "dur"),
                  str(tmp_path / "b"))
    assert (tmp_path / "cli.list").read_text() == (tmp_path / "b").read_text()


def test_blobstore_reads_jax_blob(corpus):
    path = corpus["stores"]["noise"]
    store = open_store(path, seed=3)
    assert isinstance(store, BlobData) and len(store) == 3
    with open(path + ".idx") as f:
        index = [line.split() for line in f]
    with open(path + ".blob", "rb") as f:
        blob = f.read()
    for i, (key, offset, size) in enumerate(index):
        got_key, data = store.get(i)
        assert got_key == key
        assert bytes(data) == blob[int(offset):int(offset) + int(size)]
    draws = [store.random_one()[0] for _ in range(5)]
    clone = pickle.loads(pickle.dumps(open_store(path, seed=3)))
    assert [clone.random_one()[0] for _ in range(5)] == draws
    store.close()
    clone.close()


@pytest.mark.parametrize("kind", ["recipe", "buckets", "aug"])
@pytest.mark.parametrize("split", ["train", "cv"])
def test_dataset_batches_match_jax(corpus, kind, split):
    """Epochs 0 and 1 of ``init_dataset``: keys and every array equal."""
    conf = conf_of(kind, corpus["stores"])

    def run(make):
        ds = make(corpus["list"], conf, split=split, rank=0, world_size=1,
                  seed=5)
        out = []
        for epoch in (0, 1):
            ds.set_epoch(epoch)
            out.append(list(ds))
        return out

    want = run(jax_init_dataset)
    got = run(init_dataset)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    if kind == "buckets" and split == "cv":
        assert any(b["valid"].min() == 0 for b in got[0])  # fill rows


@pytest.mark.parametrize("kind", ["recipe", "buckets"])
@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_match_jax(corpus, kind, workers):
    """Through the DataLoader (spawned workers with shared-memory
    batches, or the thread prefetcher), two epochs.  The recipe's
    unbucketed batches arrive from the workers in either order, so they
    are compared sorted by their first key."""
    conf = conf_of(kind, corpus["stores"])

    def run(make, loader_cls):
        loader = loader_cls(make(corpus["list"], conf, split="train",
                                 rank=0, world_size=1, seed=5),
                            num_workers=workers)
        out = []
        try:
            for epoch in (0, 1):
                loader.set_epoch(epoch)
                batches = list(loader)
                if kind == "recipe" and workers:
                    batches.sort(key=lambda b: b["keys"][0])
                out.append(batches)
        finally:
            loader.close()
        return out

    want = run(jax_init_dataset, JaxDataLoader)
    got = run(init_dataset, DataLoader)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)


def test_loader_raises_when_a_worker_fails(tmp_path):
    """A worker whose pipeline raises (a line that is not JSON) fails
    the epoch with its traceback and the workers are torn down; the
    thread prefetcher raises the error itself."""
    good = json.dumps({"key": "train_0", "txt": "0",
                       "wav": os.path.join(WAVS, "train_0.wav")})
    bad_list = tmp_path / "bad.list"
    bad_list.write_text("\n".join([good, "not json", good, good]) + "\n")
    for workers, error in ((2, RuntimeError), (0, json.JSONDecodeError)):
        loader = DataLoader(init_dataset(str(bad_list), BASE_CONF,
                                         split="cv"), num_workers=workers)
        try:
            with pytest.raises(error, match="JSONDecodeError|Expecting"):
                list(loader)
            assert loader._procs is None
        finally:
            loader.close()
