"""The port's other backbones (ROADMAP A.7) against the JAX package on
the CPU: the GRU backbone and ``cnn1d_s1`` preprocessing
(``Conv1dSubsampling1``) with the same weights (bridged by
tools/from_jax.py): eval forward, chunked streaming and caches, a JAX
``.ckpt`` through ``load_model_state``, the GRU on the streaming engine
against JAX's, and the initial draw.  ``Trainer`` step 0 of these
models: tests/test_torch_backbone_train.py."""

import logging

import jax
import numpy as np
import pytest
import torch
import yaml

from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.runtime import BatchMaxPoolSpotter as JaxBatchMaxPoolSpotter
from wekws_tpu.train import save_checkpoint as jax_save_checkpoint
from wekws_tpu_torch.frontend import compute_fbank_np
from wekws_tpu_torch.models import GRU, init_model
from wekws_tpu_torch.models.subsampling import Conv1dSubsampling1
from wekws_tpu_torch.runtime import BatchMaxPoolSpotter, KeyWordSpotter
from wekws_tpu_torch.runtime.keyword_spotter import load_spotter_config
from wekws_tpu_torch.tools.from_jax import model_from_jax
from wekws_tpu_torch.train import load_model_state

IDIM, HDIM = 20, 16
ATOL = RTOL = 1e-5
def _conf(kind):
    """A small wake-word model (linear head + sigmoid): ``gru`` (linear
    prep, 2 layers), ``gru_none`` (no prep), ``cnn1d_s1`` (one DS-TCN
    block after the conv prep), ``tcn`` (full-conv TCN, dropout 0)."""
    prep = {"gru_none": "none", "cnn1d_s1": "cnn1d_s1"}.get(kind, "linear")
    if kind.startswith("gru"):
        backbone = {"type": "gru", "num_layers": 2}
    else:
        backbone = {"type": "tcn", "ds": kind == "cnn1d_s1",
                    "num_layers": 1 if kind == "cnn1d_s1" else 2,
                    "kernel_size": 3, "dropout": 0.0}
    return {"input_dim": IDIM, "output_dim": 2,
            "hidden_dim": IDIM if kind == "gru_none" else HDIM,
            "preprocessing": {"type": prep}, "backbone": backbone}


def _jax_and_port(conf, seed=0):
    """Flax model + variables (BN statistics nudged off the identity)
    and the port model holding the same weights."""
    model = jax_init_model(conf)
    x0 = np.zeros((1, 8, conf["input_dim"]), np.float32)
    variables = model.init(jax.random.PRNGKey(seed), x0)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * np.arange(a.size, dtype=np.float32)
        .reshape(a.shape) / max(a.size, 1),
        variables.get("batch_stats", {}))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return model, {"params": params, "batch_stats": stats}, model_from_jax(
        params, stats, conf)


@pytest.mark.parametrize("kind", ["gru", "gru_none", "cnn1d_s1"])
def test_forward_and_streaming_match_flax(rng, kind):
    """Eval forward 1e-5 abs + 1e-5 rel; 8-frame chunks with the carried
    cache against flax's chunks, outputs and every cache.  The GRU's
    chunks equal its whole-utterance forward and its cache is the JAX
    layout (B, layers, H).  ``cnn1d_s1`` keeps no cache in either
    package: each chunk starts from two zero frames, so its chunks equal
    JAX's chunks, not the whole utterance (ROADMAP C)."""
    conf = _conf(kind)
    jmodel, variables, pmodel = _jax_and_port(conf, seed=1)
    x = rng.standard_normal((3, 24, IDIM)).astype(np.float32)
    apply = jax.jit(jmodel.apply)
    want, _ = apply(variables, x)
    with torch.inference_mode():
        got, _ = pmodel(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    jcache, pcache = jmodel.init_cache(3), pmodel.init_cache(3)
    jouts, pouts = [], []
    with torch.inference_mode():
        for s in range(0, 24, 8):
            y, jcache = apply(variables, x[:, s:s + 8], jcache)
            jouts.append(np.asarray(y))
            y, pcache = pmodel(torch.from_numpy(x[:, s:s + 8]), pcache)
            pouts.append(y.numpy())
    streamed = np.concatenate(pouts, axis=1)
    np.testing.assert_allclose(streamed, np.concatenate(jouts, axis=1),
                               atol=ATOL, rtol=RTOL)
    jleaves = jax.tree_util.tree_leaves(jcache)
    pleaves = [pcache] if isinstance(pcache, torch.Tensor) else list(pcache)
    assert len(jleaves) == len(pleaves)
    for pc, jc in zip(pleaves, jleaves):
        assert tuple(pc.shape) == jc.shape
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=ATOL,
                                   rtol=RTOL)
    if kind.startswith("gru"):
        assert isinstance(pmodel.backbone, GRU)
        assert tuple(pcache.shape) == (3, 2, conf["hidden_dim"])
        np.testing.assert_allclose(streamed, got.numpy(), atol=ATOL,
                                   rtol=RTOL)
    else:
        assert isinstance(pmodel.preprocessing, Conv1dSubsampling1)


def test_gru_equals_torch_nn_gru(rng):
    """The backbone's parameters are ``nn.GRU``'s by name and layout, and
    its recurrence is ``nn.GRU``'s (on the CPU: no cuDNN), from a given
    hidden state too."""
    gru = init_model(_conf("gru")).backbone
    ref = torch.nn.GRU(HDIM, HDIM, 2, batch_first=True)
    ref.load_state_dict(gru.state_dict())
    x = torch.from_numpy(rng.standard_normal((4, 25, HDIM)).astype(
        np.float32))
    h0 = torch.from_numpy(rng.standard_normal((4, 2, HDIM)).astype(
        np.float32))
    with torch.no_grad():
        got, got_h = gru(x, h0)
        want, want_h = ref(x, h0.transpose(0, 1).contiguous())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got_h.numpy(), want_h.transpose(0, 1).numpy(),
                               atol=ATOL, rtol=RTOL)
    y, h = gru(x[:, :0], h0)
    assert y.shape == (4, 0, HDIM) and torch.equal(h, h0)


@pytest.mark.parametrize("kind", ["gru", "cnn1d_s1"])
def test_jax_checkpoint_loads_through_load_model_state(tmp_path, rng, kind):
    """A JAX-package ``.ckpt`` (params and batch_stats) loads into
    ``init_model``'s model and scores as flax does."""
    conf = _conf(kind)
    jmodel, variables, _ = _jax_and_port(conf, seed=2)
    ckpt = tmp_path / "final.ckpt"
    jax_save_checkpoint(str(ckpt), variables["params"],
                        variables["batch_stats"])
    model = init_model(conf)
    model.load_state_dict(load_model_state(str(ckpt), conf, model))
    x = rng.standard_normal((2, 30, IDIM)).astype(np.float32)
    want, _ = jmodel.apply(variables, x)
    with torch.inference_mode():
        got, _ = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_gru_streams_on_module_engine_as_jax(tmp_path):
    """``BatchMaxPoolSpotter(use_fused=False)`` serves a GRU wake-word
    model from a JAX ``.ckpt``: every active row's posteriors, stepped in
    8-frame lockstep steps and flushed, within 1e-5 of the JAX engine's,
    and the GRU hidden state is the engine's (streams, layers, H) cache.
    ``use_fused=True`` raises (no serving kernel for a GRU)."""
    rng = np.random.default_rng(5)
    configs = {"dataset_conf": {
        "feats_type": "fbank",
        "fbank_conf": {"num_mel_bins": IDIM, "frame_shift": 10,
                       "frame_length": 25, "dither": 1.0}},
        "model": _conf("gru")}
    waves = [(rng.standard_normal(9000 + 2000 * i) * 1000).astype("<i2")
             for i in range(2)]
    _, cfg, _, _, _ = load_spotter_config(configs)
    feats = np.concatenate([compute_fbank_np(w.astype(np.float32), cfg)
                            for w in waves])
    configs["model"]["cmvn"] = {
        "mean": feats.mean(0).tolist(),
        "istd": (1.0 / (feats.std(0) + 1e-6)).tolist(), "norm_var": True}
    config = tmp_path / "config.yaml"
    config.write_text(yaml.dump(configs))
    _, variables, _ = _jax_and_port(configs["model"], seed=6)
    ckpt = tmp_path / "final.ckpt"
    jax_save_checkpoint(str(ckpt), variables["params"],
                        variables["batch_stats"])
    probs = {}
    for name, engine, attr in (
            ("jax", JaxBatchMaxPoolSpotter(str(ckpt), str(config), 2.0,
                                           num_streams=2, step_frames=8),
             "_step_jit"),
            ("port", BatchMaxPoolSpotter(str(ckpt), str(config), 2.0,
                                         num_streams=2, step_frames=8,
                                         device="cpu"), "_step_fn")):
        probs[name] = [[], []]
        orig = getattr(engine, attr)

        def capture(feats, active, reset, cache, _orig=orig, _out=name):
            out, c = _orig(feats, active, reset, cache)
            p = np.asarray(out)
            for i in range(2):
                if active[i]:
                    probs[_out][i].append(p[i])
            return out, c

        setattr(engine, attr, capture)
        for i, w in enumerate(waves):
            engine.accept_wave(i, w.tobytes())
        engine.flush()
        if name == "port":
            assert tuple(engine.cache.shape) == (2, 2, HDIM)
    for got, want in zip(probs["port"], probs["jax"]):
        got, want = np.concatenate(got), np.concatenate(want)
        assert got.shape == want.shape and got.shape[0] > 50
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    with pytest.raises(NotImplementedError, match="GRU"):
        BatchMaxPoolSpotter(str(ckpt), str(config), 2.0, use_fused=True,
                            device="cpu")


def test_gru_ctc_model_on_keyword_spotter(tmp_path):
    """``KeyWordSpotter`` (module engine, device="cpu") steps a GRU CTC
    model (identity head, softmax) on 300 ms chunks, carrying the
    hidden state: its posteriors equal the offline softmax forward on
    the same host features within 1e-5."""
    rng = np.random.default_rng(8)
    conf = dict(_conf("gru"), output_dim=4,
                classifier={"type": "identity"},
                activation={"type": "identity"})
    configs = {"dataset_conf": {
        "feats_type": "fbank",
        "fbank_conf": {"num_mel_bins": IDIM, "frame_shift": 10,
                       "frame_length": 25, "dither": 0.0}},
        "model": conf}
    model = init_model(conf, torch.Generator().manual_seed(8))
    ckpt = tmp_path / "gru_ctc.pt"
    torch.save(model.state_dict(), ckpt)
    tokens = tmp_path / "tokens.txt"
    tokens.write_text("<blk> 0\na 1\nb 2\nc 3\n")
    spot = KeyWordSpotter(str(ckpt), configs, str(tokens), None, 0.5,
                          device="cpu")
    wave = (rng.standard_normal(12000) * 1000).astype("<i2")
    probs = []
    orig = spot._apply_step

    def capture(feats, cache):
        out, c = orig(feats, cache)
        probs.append(out)
        return out, c

    spot._apply_step = capture
    pcm, step = wave.tobytes(), 2 * 4800
    for off in range(0, len(pcm), step):
        spot.forward(pcm[off:off + step])
    assert tuple(spot.in_cache.shape) == (1, 2, HDIM)
    _, cfg, _, _, _ = load_spotter_config(configs)
    feats = compute_fbank_np(wave.astype(np.float32), cfg)
    with torch.inference_mode():
        want, _ = model(torch.from_numpy(feats[None]), softmax=True)
    got = torch.cat(probs, dim=1)
    assert got.shape == want.shape and len(probs) > 2
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)


def test_gru_init_draw_and_dtype_warning(caplog):
    """flax's lecun normal per product (fan_in D for ``weight_ih``, H for
    ``weight_hh``), zero biases; a bf16 ``dtype`` on a GRU config logs
    the JAX package's warning and builds a float32 model."""
    conf = dict(_conf("gru_none"), hidden_dim=64, dtype="bfloat16")
    conf["input_dim"] = 48
    with caplog.at_level(logging.WARNING):
        model = init_model(conf, torch.Generator().manual_seed(0))
    assert "not supported for the gru backbone" in caplog.text
    gru = model.backbone
    for k, fan_in in ((0, 48), (1, 64)):
        w_ih, b_ih, w_hh, b_hh = gru.layer_weights(k)
        for w, fan in ((w_ih, fan_in), (w_hh, 64)):
            assert w.dtype == torch.float32
            sigma = 1.0 / (0.87962566103423978 * np.sqrt(fan))
            w = w.detach()
            assert float(w.abs().max()) <= 2.0 * sigma * (1 + 1e-6)
            assert abs(float(w.double().var()) * fan - 1.0) < 0.15
        assert not b_ih.any() and not b_hh.any()
