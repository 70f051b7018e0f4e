"""Port batched serving (runtime/device_frontend.py, the MFCC streaming
frontend, BatchKeywordSpotter, models/cache.py, the serving CLIs)
against the JAX package on the CPU, on the same numpy inputs and the
same weights (bridged through tools/from_jax)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from wekws_tpu.bin import batch_stream_kws as jax_batch_cli
from wekws_tpu.bin import stream_kws_ctc as jax_stream_cli
from wekws_tpu.frontend import kaldi as jax_kaldi
from wekws_tpu.models import cache as jax_cache
from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.runtime import BatchKeywordSpotter as JaxBatchKeywordSpotter
from wekws_tpu.runtime import StreamingFrontend as JaxStreamingFrontend
from wekws_tpu.runtime.device_frontend import (
    WaveStreamBuffer as JaxWaveStreamBuffer,
)
from wekws_tpu.runtime.device_frontend import (
    build_batch_featurizer as jax_build_batch_featurizer,
)
from wekws_tpu.train import save_checkpoint
from wekws_tpu_torch.bin import batch_stream_kws, stream_kws_ctc
from wekws_tpu_torch.data.audio import write_wav
from wekws_tpu_torch.frontend import kaldi
from wekws_tpu_torch.frontend.features import FeatureExtractor
from wekws_tpu_torch.models import cache
from wekws_tpu_torch.runtime import (
    BatchKeywordSpotter,
    BatchMaxPoolSpotter,
    StreamingFrontend,
)
from wekws_tpu_torch.runtime.device_frontend import (
    WaveStreamBuffer,
    build_batch_featurizer,
)
from wekws_tpu_torch.tools.from_jax import model_from_jax

GEOMETRIES = [
    pytest.param(0, 0, 1, id="plain"),        # flagship max-pooling
    pytest.param(2, 2, 3, id="splice-skip"),  # hi_xiaowen FSMN-CTC
    pytest.param(1, 2, 2, id="asymmetric"),
]
# uneven chunking exercises every carry-over path
CHUNKS = [389, 1600, 111, 4800, 2000, 7919, 16000, 15181]
M = 8  # step_frames


def _cfgs(feature_type):
    kw = dict(feature_type=feature_type, num_mel_bins=23,
              num_ceps=23 if feature_type == "fbank" else 13, dither=0.0)
    return kaldi.FrontendConfig(**kw), jax_kaldi.FrontendConfig(**kw)


# ---------------------------------------------------------------- (a)


@pytest.mark.parametrize("left,right,skip", GEOMETRIES)
def test_wave_buffer_equals_jax(rng, left, right, skip):
    """Windows, ``lo``, available outputs and consumed indices equal
    the JAX buffer's exactly over uneven chunks, the flush of a padded
    tail (a consume past the buffered data) and a reset."""
    cfg, _ = _cfgs("fbank")
    args = (cfg.frame_shift, cfg.frame_length, left, right, skip, M)
    got, want = WaveStreamBuffer(*args), JaxWaveStreamBuffer(*args)
    assert got.window_samples == want.window_samples
    wave = (rng.standard_normal(sum(CHUNKS)) * 1000).astype(np.float32)
    off, steps = 0, 0
    for ch in CHUNKS:
        for buf in (got, want):
            buf.append(wave[off:off + ch])
        off += ch
        while True:
            n = got.available_outputs()
            assert n == want.available_outputs()
            if n < M:
                break
            (w_got, lo_got), (w_want, lo_want) = got.window(), want.window()
            np.testing.assert_array_equal(w_got, w_want)
            assert lo_got == lo_want
            np.testing.assert_array_equal(got.consume(M), want.consume(M))
            assert got.next_index == want._next
            steps += 1
    # the padded tail: fewer than M outputs, consumed as a whole step
    (w_got, lo_got), (w_want, lo_want) = got.window(), want.window()
    np.testing.assert_array_equal(w_got, w_want)
    assert lo_got == lo_want
    np.testing.assert_array_equal(got.consume(M), want.consume(M))
    got.append(wave[:3000])
    want.append(wave[:3000])
    assert got.available_outputs() == want.available_outputs()
    np.testing.assert_array_equal(got.window()[0], want.window()[0])
    for buf in (got, want):
        buf.reset()
    assert got.next_index == want._next == 0 and got.window()[1] == left
    assert steps > 10


# ---------------------------------------------------------------- (b)


@pytest.mark.parametrize("feature_type", ["fbank", "mfcc"])
@pytest.mark.parametrize("left,right,skip", GEOMETRIES)
def test_featurizer_matches_jax(rng, feature_type, left, right, skip):
    """The port's featurizer (``fused_fbank``'s plain chain on the CPU)
    against JAX's ``build_batch_featurizer`` on the same windows, four
    streams at once (one at the stream head, where ``lo`` clamps):
    1e-4 abs + 1e-5 rel, the extractors' own bound
    (tests/test_torch_device_frontend.py: float32 products summed in
    another order).  Against the port's host ``StreamingFrontend`` the
    valid frames agree within JAX's own pin, 2e-3 abs."""
    cfg, jcfg = _cfgs(feature_type)
    featurize, window_samples = build_batch_featurizer(
        cfg, left, right, skip, M, device="cpu")
    jfeaturize, jwindow = jax_build_batch_featurizer(jcfg, left, right,
                                                     skip, M)
    assert window_samples == jwindow
    bufs = [WaveStreamBuffer(cfg.frame_shift, cfg.frame_length, left, right,
                             skip, M) for _ in range(4)]
    host = StreamingFrontend(cfg, left, right, skip)
    wave = (rng.standard_normal(3 * 16000) * 1000).astype(np.float32)
    for i, buf in enumerate(bufs):
        buf.append(wave[:16000 + 4000 * i])
    host_feats, _ = host.accept_waveform(wave)
    for _ in range(3):
        waves = np.stack([b.window()[0] for b in bufs])
        lo = np.array([b.window()[1] for b in bufs])
        got = featurize(waves, lo).numpy()
        want = np.asarray(jfeaturize(jnp.asarray(waves), jnp.asarray(lo)))
        assert got.shape == want.shape == (4, M, cfg.feat_dim
                                           * (left + 1 + right))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
        idx = bufs[0].consume(M) // skip
        np.testing.assert_allclose(got[0], host_feats[idx], rtol=0,
                                   atol=2e-3)
        for b in bufs[1:]:
            b.consume(M)


# ---------------------------------------------------------------- (c)


def _streamed(frontend, wave):
    feats, idx = [], []
    off = 0
    for ch in CHUNKS:
        f, i = frontend.accept_waveform(wave[off:off + ch])
        off += ch
        if len(i):  # JAX's empty chunk is num_ceps wide, its fbank not
            feats.append(f)
            idx.append(i)
    return np.concatenate(feats), np.concatenate(idx)


def test_streaming_frontend_mfcc_matches_offline(rng):
    """ROADMAP C.10: for an MFCC configuration the port's streaming
    frontend computes MFCC.  Streamed in uneven chunks it equals
    ``compute_mfcc_np`` on the whole wave (float64 per frame: 1e-5) and
    the offline extractor (float32 products: 2e-3 abs, JAX's pin of the
    device featurizer against the host frontend)."""
    cfg, _ = _cfgs("mfcc")
    wave = (rng.standard_normal(sum(CHUNKS)) * 1000).astype(np.float32)
    got, idx = _streamed(StreamingFrontend(cfg), wave)
    want = kaldi.compute_mfcc_np(wave, cfg)
    assert got.shape == want.shape == (len(want), 13)
    np.testing.assert_array_equal(idx, np.arange(len(want)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    offline, _ = FeatureExtractor(cfg)(torch.from_numpy(wave[None]))
    np.testing.assert_allclose(got, offline[0].numpy(), rtol=0, atol=2e-3)


def test_streaming_frontend_mfcc_departs_from_jax(rng):
    """The deliberate departure (C.10): the JAX streaming frontend
    computes log-mel fbank for the same MFCC configuration, the port's
    MFCC; for fbank the two agree."""
    cfg, jcfg = _cfgs("mfcc")
    wave = (rng.standard_normal(sum(CHUNKS)) * 1000).astype(np.float32)
    got, _ = _streamed(StreamingFrontend(cfg), wave)
    jax_got, _ = _streamed(JaxStreamingFrontend(jcfg), wave)
    assert jax_got.shape[1] == 23 and got.shape[1] == 13
    np.testing.assert_allclose(jax_got, jax_kaldi.compute_fbank_np(
        wave, jcfg), rtol=1e-5, atol=1e-5)
    cfg, jcfg = _cfgs("fbank")
    got, _ = _streamed(StreamingFrontend(cfg), wave)
    jax_got, _ = _streamed(JaxStreamingFrontend(jcfg), wave)
    np.testing.assert_allclose(got, jax_got, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- (e)

HEAD = {"classifier": {"type": "element", "dropout": 0.0},
        "activation": {"type": "identity"}}
MODELS = {
    # tests/test_serving.py's DS-TCN, a CTC head, 23 mel, no context
    "ds_tcn": ({"feats_type": "fbank",
                "fbank_conf": {"num_mel_bins": 23, "frame_shift": 10,
                               "frame_length": 25, "dither": 1.0}},
               dict(HEAD, input_dim=23, output_dim=4, hidden_dim=16,
                    preprocessing={"type": "linear"},
                    backbone={"type": "tcn", "ds": True, "num_layers": 2,
                              "kernel_size": 4, "dropout": 0.0})),
    # an FSMN at 3 x 32/16 with hi_xiaowen's context 2/2 and skip 3
    "fsmn": ({"feats_type": "fbank",
              "fbank_conf": {"num_mel_bins": 23, "frame_shift": 10,
                             "frame_length": 25, "dither": 1.0},
              "context_expansion": True,
              "context_expansion_conf": {"left": 2, "right": 2},
              "frame_skip": 3},
             {"input_dim": 115, "output_dim": 4, "hidden_dim": 24,
              "preprocessing": {"type": "none"},
              "backbone": {"type": "fsmn", "input_affine_dim": 24,
                           "num_layers": 3, "linear_dim": 32,
                           "proj_dim": 16, "left_order": 4,
                           "right_order": 1, "left_stride": 1,
                           "right_stride": 1, "output_affine_dim": 24},
              "classifier": {"type": "identity", "dropout": 0.0},
              "activation": {"type": "identity"}}),
}
# random weights whose noise posteriors make the keywords fire
SEEDS = {"ds_tcn": 0, "fsmn": 2}
KEYWORDS = "hi,hx"
CHUNK_BYTES = [9600, 19200, 6400]  # 300, 600 and 200 ms of int16


def _write_model(tmp, name, seed):
    """JAX checkpoint + bridged port checkpoint of ``MODELS[name]``."""
    dataset_conf, model_conf = MODELS[name]
    configs = {"dataset_conf": dataset_conf, "model": model_conf}
    config = tmp / "config.yaml"
    config.write_text(yaml.dump(configs))
    model = jax_init_model(model_conf)
    variables = model.init(jax.random.PRNGKey(seed), np.zeros(
        (1, 10, model_conf["input_dim"]), np.float32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray,
                                   dict(variables.get("batch_stats", {})))
    jax_ckpt = tmp / "final.ckpt"
    save_checkpoint(str(jax_ckpt), params, stats)
    port_ckpt = tmp / "final.pt"
    torch.save(model_from_jax(params, stats or None,
                              model_conf).state_dict(), port_ckpt)
    tokens = tmp / "tokens.txt"
    tokens.write_text("<blk> 0\nh 1\ni 2\nx 3\n")
    return str(jax_ckpt), str(port_ckpt), str(config), str(tokens)


def _drive(eng, waves, reset_at=None):
    """Staggered chunks (three sizes), every step drained, stream 0
    reset after round ``reset_at``, then a flush: the sorted detections
    (stream, keyword, start, end, score)."""
    out = []

    def take(results):
        out.extend((i, r["keyword"], round(r["start"], 2),
                    round(r["end"], 2), r["score"])
                   for i, r in results.items() if r and r.get("state") == 1)

    offsets = [0] * len(waves)
    rounds = 0
    while any(offsets[i] < len(waves[i]) for i in range(len(waves))):
        for i, pcm in enumerate(waves):
            if offsets[i] < len(pcm):
                eng.accept_wave(i, pcm[offsets[i]:offsets[i]
                                       + CHUNK_BYTES[i]])
                offsets[i] += CHUNK_BYTES[i]
        while True:
            results = eng.step()
            if not results:
                break
            take(results)
        rounds += 1
        if rounds == reset_at:
            eng.reset_stream(0)
    take(eng.flush())
    return sorted(out)


@pytest.fixture(scope="module", params=sorted(MODELS))
def kws(request, tmp_path_factory):
    """One model's checkpoints, three streams of noise, and the JAX
    engine's detections (host decode, and device decode with and
    without the device frontend) with and without a mid-stream
    reset."""
    tmp = tmp_path_factory.mktemp(request.param)
    jax_ckpt, port_ckpt, config, tokens = _write_model(
        tmp, request.param, SEEDS[request.param])
    rng = np.random.default_rng(5)
    waves = [(rng.standard_normal(24000) * 3000).astype("<i2").tobytes()
             for _ in range(3)]
    want = {}
    for mode in ("host", "device", "device_frontend"):
        eng = JaxBatchKeywordSpotter(
            jax_ckpt, config, tokens, None, threshold=0.05, num_streams=3,
            step_frames=M, min_frames=1, device_decode=mode != "host",
            device_frontend=mode == "device_frontend")
        eng.set_keywords(KEYWORDS)
        for reset_at in (None, 2):
            # reset_all: every slot as new (one jit compile per mode)
            eng.reset_all()
            want[mode, reset_at] = _drive(eng, waves, reset_at)
    return dict(name=request.param, ckpt=port_ckpt, config=config,
                tokens=tokens, waves=waves, want=want)


def _port_engine(kws, **kw):
    eng = BatchKeywordSpotter(kws["ckpt"], kws["config"], kws["tokens"],
                              None, threshold=0.05, num_streams=3,
                              step_frames=M, min_frames=1, device="cpu",
                              **kw)
    eng.set_keywords(KEYWORDS)
    return eng


def _same_detections(got, want, score_tol):
    assert [d[:4] for d in got] == [d[:4] for d in want]
    for g, w in zip(got, want):
        assert g[4] == pytest.approx(w[4], rel=score_tol, abs=score_tol)


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("mode", ["host", "device", "device_frontend"])
@pytest.mark.parametrize("reset_at", [None, 2])
def test_batch_keyword_spotter_matches_jax(kws, mode, use_fused, reset_at):
    """``BatchKeywordSpotter`` (host decode; device decode; device decode
    with the device frontend) against JAX's in the same mode, on the
    module route and on the fused one (the kernels' plain versions on
    the CPU): the same detections (stream, keyword, start, end) over
    staggered chunks, a mid-stream reset and the flush; scores within
    1e-4 (posteriors agree to 1e-5: float32 with another summation
    order, multiplied into the hit score)."""
    eng = _port_engine(kws, use_fused=use_fused,
                       device_decode=mode != "host",
                       device_frontend=mode == "device_frontend")
    want = kws["want"][mode, reset_at]
    assert want, "threshold too high: no detections, the test is vacuous"
    _same_detections(_drive(eng, kws["waves"], reset_at), want, 1e-4)


def test_device_decode_requires_keywords(kws):
    eng = BatchKeywordSpotter(kws["ckpt"], kws["config"], kws["tokens"],
                              None, 0.5, num_streams=1, step_frames=4,
                              device_decode=True, device="cpu")
    eng.accept_wave(0, np.zeros(8000, "<i2").tobytes())
    with pytest.raises(RuntimeError, match="set_keywords"):
        eng.step()


def test_device_frontend_reset_stream(kws):
    """``reset_stream`` clears the wave buffer and its cursor."""
    eng = _port_engine(kws, device_frontend=True)
    eng.accept_wave(0, kws["waves"][0][:16000])
    assert eng.pending_frames(0) > 0
    eng.step()
    eng.reset_stream(0)
    assert eng.pending_frames(0) == 0 and eng.sources[0].next_index == 0


def test_maxpool_device_frontend_equals_host_frontend(tmp_path):
    """``BatchMaxPoolSpotter(device_frontend=True)`` steps the same
    schedule as the host frontend and the posteriors of every valid
    frame agree within 1e-4 (the extractor's float32 products against
    the host's float64 numpy)."""
    dataset_conf, model_conf = MODELS["ds_tcn"]
    model_conf = dict(model_conf, output_dim=2)
    model_conf.pop("classifier")
    model_conf.pop("activation")
    configs = {"dataset_conf": dataset_conf, "model": model_conf}
    from wekws_tpu_torch.models import init_model

    torch.manual_seed(0)
    ckpt = tmp_path / "m.pt"
    torch.save(init_model(model_conf).state_dict(), ckpt)
    rng = np.random.default_rng(3)
    pcm = [(rng.standard_normal(20000) * 2000).astype("<i2").tobytes()
           for _ in range(2)]
    runs = {}
    for device_frontend in (False, True):
        eng = BatchMaxPoolSpotter(str(ckpt), configs, 2.0, num_streams=2,
                                  use_fused=True,
                                  device_frontend=device_frontend,
                                  device="cpu")
        steps = []  # (posteriors, {row: valid frames}) per step
        step_fn, consume = eng._step_fn, eng._consume

        def capture(feats, active, reset, cache, _fn=step_fn, _s=steps):
            out, c = _fn(feats, active, reset, cache)
            _s.append((out.numpy(), {}))
            return out, c

        def consumed(i, k, _fn=consume, _s=steps):
            _s[-1][1][i] = k
            return _fn(i, k)

        eng._step_fn, eng._consume = capture, consumed
        for off in range(0, 40000, 6400):
            for i in range(2):
                eng.accept_wave(i, pcm[i][off:off + 6400 * (i + 1)])
            eng.step()
        eng.flush()
        runs[device_frontend] = steps
    assert [s[1] for s in runs[True]] == [s[1] for s in runs[False]]
    assert any(k < M for s in runs[True] for k in s[1].values())  # a tail
    for (got, rows), (want, _) in zip(runs[True], runs[False]):
        for i, k in rows.items():
            np.testing.assert_allclose(got[i, :k], want[i, :k], atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("route", ["module", "fused"])
def test_engine_route_from_loaded_model(kws, monkeypatch, route):
    """``use_fused=None`` takes ``forward_route``'s route for the model
    the engine loaded (the card is mocked by patching the route): the
    fused builder runs only on the fused route, and the detections are
    JAX's either way."""
    import wekws_tpu_torch.runtime.batch_spotter as bs

    seen, built = [], []
    real = bs.build_fused_stream

    def route_of(model, device):
        seen.append((type(model.backbone).__name__, device.type))
        return route

    def building(*args, **kwargs):
        built.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(bs, "forward_route", route_of)
    monkeypatch.setattr(bs, "build_fused_stream", building)
    eng = _port_engine(kws, use_fused=None)
    assert [d for _, d in seen] == ["cpu"]
    assert built == ([eng.model] if route == "fused" else [])
    _same_detections(_drive(eng, kws["waves"]), kws["want"]["host", None],
                     1e-4)


def test_fused_engine_raises_for_gru(tmp_path):
    """No fused stream for a GRU: ``use_fused=True`` raises, never falls
    back to the modules."""
    from wekws_tpu_torch.models import init_model

    model_conf = {"input_dim": 23, "output_dim": 4, "hidden_dim": 16,
                  "preprocessing": {"type": "none"},
                  "backbone": {"type": "gru", "num_layers": 1},
                  "classifier": {"type": "identity", "dropout": 0.0},
                  "activation": {"type": "identity"}}
    configs = {"dataset_conf": MODELS["ds_tcn"][0], "model": model_conf}
    ckpt = tmp_path / "gru.pt"
    torch.save(init_model(model_conf).state_dict(), ckpt)
    tokens = tmp_path / "tokens.txt"
    tokens.write_text("<blk> 0\nh 1\ni 2\nx 3\n")
    with pytest.raises(NotImplementedError):
        BatchKeywordSpotter(str(ckpt), configs, str(tokens), None, 0.5,
                            use_fused=True, device="cpu")
    BatchKeywordSpotter(str(ckpt), configs, str(tokens), None, 0.5,
                        device="cpu").set_keywords(KEYWORDS)


# ------------------------------------------------------------ the CLIs


def _run_jax_cli(module, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    module.main()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("device_decode", [False, True])
def test_batch_stream_kws_cli_matches_jax(kws, tmp_path, capsys,
                                          monkeypatch, device_decode):
    """``bin.batch_stream_kws`` prints the JAX CLI's detection lines for
    the same wavs, three streams over two wavs repeated twice."""
    wavs = []
    for i, pcm in enumerate(kws["waves"][:2]):
        wavs.append(str(tmp_path / f"w{i}.wav"))
        write_wav(wavs[-1], np.frombuffer(pcm, "<i2") / 32768.0, 16000)
    jax_ckpt = kws["ckpt"].replace(".pt", ".ckpt")
    argv = ["--config", kws["config"], "--token_file", kws["tokens"],
            "--keywords", KEYWORDS, "--threshold", "0.05", "--min_frames",
            "1", "--streams", "3", "--repeat", "2", "--wav_paths", *wavs]
    argv += ["--device_decode"] if device_decode else []
    want = _run_jax_cli(jax_batch_cli, argv + ["--checkpoint", jax_ckpt],
                        capsys, monkeypatch)
    out = batch_stream_kws.main(argv + ["--checkpoint", kws["ckpt"],
                                        "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[:-1] == want[:-1] and len(got) > 1
    assert len(out["detections"]) == len(got) - 1
    assert out["stats"]["dispatches"] > 0
    # --mesh_devices (ported since, A.13) asks for cards; the CPU is one
    with pytest.raises(ValueError, match="--mesh_devices 2: this machine "
                                         "has 1 cpu device"):
        batch_stream_kws.main(argv + ["--checkpoint", kws["ckpt"],
                                      "--device", "cpu", "--mesh_devices",
                                      "2"])


def test_stream_kws_ctc_cli_matches_jax(kws, tmp_path, capsys, monkeypatch):
    """``bin.stream_kws_ctc`` prints the JAX CLI's detection lines."""
    wav = str(tmp_path / "w.wav")
    pcm = b"".join(kws["waves"][::-1])
    write_wav(wav, np.frombuffer(pcm, "<i2") / 32768.0, 16000)
    argv = ["--config", kws["config"], "--token_file", kws["tokens"],
            "--keywords", KEYWORDS, "--threshold", "0.05", "--min_frames",
            "1", "--wav_path", wav]
    want = _run_jax_cli(jax_stream_cli, argv + [
        "--checkpoint", kws["ckpt"].replace(".pt", ".ckpt")], capsys,
        monkeypatch)
    out = stream_kws_ctc.main(argv + ["--checkpoint", kws["ckpt"],
                                      "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == want
    assert len(out) == len(want) > 0


# ---------------------------------------------------------------- (h)


def test_cache_helpers_round_trip_and_equal_jax(rng):
    """``concat_cache``/``split_cache`` round-trip a tuple cache and equal
    the JAX helpers; a GRU's hidden state passes through."""
    pads = (3, 0, 12, 7)
    parts = [rng.standard_normal((2, p, 5)).astype(np.float32)
             for p in pads]
    got = cache.concat_cache(tuple(torch.from_numpy(p) for p in parts))
    want = jax_cache.concat_cache(tuple(jnp.asarray(p) for p in parts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = cache.split_cache(got, pads)
    for b, p in zip(back, parts):
        np.testing.assert_array_equal(b.numpy(), p)
    assert cache.cache_shape(back) == jax_cache.cache_shape(
        jax_cache.split_cache(want, pads)) == (22, 5)
    hidden = torch.zeros((2, 3, 8))
    assert cache.concat_cache(hidden) is hidden
    assert cache.cache_shape(hidden) == (3, 8)
