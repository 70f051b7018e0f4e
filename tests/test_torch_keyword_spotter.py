"""Port single-stream CTC engine (runtime/keyword_spotter.py), prefix
beam search and tokenizer against the JAX package's, on the same
checkpoints (bridged through tools/from_jax) and the same inputs."""

import jax
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from wekws_tpu.decode.ctc_prefix_beam_search import PrefixBeam as JaxBeam
from wekws_tpu.decode.ctc_prefix_beam_search import (
    ctc_prefix_beam_search as jax_beam_search,
)
from wekws_tpu.decode.ctc_prefix_beam_search import is_sublist as jax_sublist
from wekws_tpu.models import init_model as jax_init_model
from wekws_tpu.runtime import KeyWordSpotter as JaxKeyWordSpotter
from wekws_tpu.runtime.keyword_spotter import StreamDetector as JaxDetector
from wekws_tpu.runtime.keyword_spotter import (
    build_keyword_tables as jax_build_keyword_tables,
)
from wekws_tpu.text import tokenizer as jax_tok
from wekws_tpu.train import save_checkpoint
from wekws_tpu_torch.decode import (
    PrefixBeam,
    ctc_prefix_beam_search,
    is_sublist,
)
from wekws_tpu_torch.runtime import KeyWordSpotter, StreamDetector
from wekws_tpu_torch.runtime.keyword_spotter import build_keyword_tables
from wekws_tpu_torch.text import tokenizer as tok
from wekws_tpu_torch.tools.from_jax import model_from_jax

DATASET_CONF = {
    "feats_type": "fbank",
    "fbank_conf": {"num_mel_bins": 23, "frame_shift": 10,
                   "frame_length": 25, "dither": 1.0},
}
HEAD = {"classifier": {"type": "identity", "dropout": 0.0},
        "activation": {"type": "identity"}}
MODELS = {
    "fsmn": dict(HEAD, input_dim=23, output_dim=4, hidden_dim=32,
                 preprocessing={"type": "none"},
                 backbone={"type": "fsmn", "input_affine_dim": 24,
                           "num_layers": 2, "linear_dim": 32, "proj_dim": 16,
                           "left_order": 4, "right_order": 1,
                           "left_stride": 1, "right_stride": 1,
                           "output_affine_dim": 24}),
    "mdtc": dict(HEAD, input_dim=23, output_dim=4, hidden_dim=16,
                 preprocessing={"type": "linear"},
                 backbone={"type": "mdtc", "num_stack": 2, "stack_size": 2,
                           "kernel_size": 5, "hidden_dim": 16,
                           "causal": True}),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def setup(request, tmp_path_factory):
    """(JAX checkpoint, port checkpoint, config, tokens) of one small
    CTC model; the port's weights are the JAX ones, bridged."""
    tmp = tmp_path_factory.mktemp(request.param)
    configs = {"dataset_conf": DATASET_CONF, "model": MODELS[request.param]}
    config_path = tmp / "config.yaml"
    config_path.write_text(yaml.dump(configs))
    model = jax_init_model(configs["model"])
    variables = model.init(jax.random.PRNGKey(0),
                           np.zeros((1, 10, 23), np.float32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray,
                                   dict(variables.get("batch_stats", {})))
    jax_ckpt = tmp / "final.ckpt"
    save_checkpoint(str(jax_ckpt), params, stats)
    port_ckpt = tmp / "final.pt"
    torch.save(model_from_jax(params, stats or None,
                              configs["model"]).state_dict(), port_ckpt)
    tokens = tmp / "tokens.txt"
    tokens.write_text("<blk> 0\nh 1\ni 2\nx 3\n")
    return str(jax_ckpt), str(port_ckpt), str(config_path), str(tokens)


def _stream(spotter, pcm, step_attr):
    """Feed 300 ms chunks; returns the captured posteriors and every
    ``forward()`` result."""
    probs = []
    orig = getattr(spotter, step_attr)

    def capture(feats, cache):
        out, c = orig(feats, cache)
        probs.append(np.asarray(out))
        return out, c

    setattr(spotter, step_attr, capture)
    results = [spotter.forward(pcm[off:off + 9600])
               for off in range(0, len(pcm), 9600)]
    return np.concatenate(probs, axis=1), results


@pytest.mark.parametrize("use_fused", [False, True])
def test_spotter_posteriors_and_results_match_jax(setup, rng, use_fused):
    """Softmax posteriors of one second of noise in 300 ms chunks, and
    the ``forward()`` result dicts.  5e-4 abs + 1e-3 rel, the JAX suite's
    bound between its fused and flax engines; the fused JAX engine runs
    its Pallas kernel in interpret mode, the port's its plain version."""
    jax_ckpt, port_ckpt, config, tokens = setup
    pcm = (rng.standard_normal(16000) * 1000).astype("<i2").tobytes()
    jspot = JaxKeyWordSpotter(jax_ckpt, config, tokens, None, threshold=0.5,
                              use_fused=use_fused)
    jspot.set_keywords("hi")
    pspot = KeyWordSpotter(port_ckpt, config, tokens, None, threshold=0.5,
                           use_fused=use_fused, device="cpu")
    pspot.set_keywords("hi")
    assert (pspot._fused_init_cache is not None) == use_fused
    assert pspot.keywords_token == jspot.keywords_token
    assert pspot.keywords_idxset == jspot.keywords_idxset == {0, 1, 2}
    with pltpu.force_tpu_interpret_mode():
        want, want_results = _stream(jspot, pcm, "_apply_jit")
    got, got_results = _stream(pspot, pcm, "_apply_step")
    assert got.shape == want.shape and got.shape[1] > 90
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    assert got_results == want_results
    assert pspot.total_frames == jspot.total_frames > 0
    pspot.reset_all()
    assert pspot.total_frames == 0 and pspot.result == {}


def test_fused_spotter_raises_where_unsupported(tmp_path):
    """The JAX engine quietly keeps the flax path when
    ``build_fused_stream`` gives None; the port raises."""
    from wekws_tpu_torch.models import init_model

    conf = dict(MODELS["mdtc"], preprocessing={"type": "none"}, input_dim=16)
    configs = {"dataset_conf": dict(DATASET_CONF, fbank_conf=dict(
        DATASET_CONF["fbank_conf"], num_mel_bins=16)), "model": conf}
    ckpt = tmp_path / "m.pt"
    torch.save(init_model(conf).state_dict(), ckpt)
    tokens = tmp_path / "tokens.txt"
    tokens.write_text("<blk> 0\nh 1\n")
    KeyWordSpotter(str(ckpt), configs, str(tokens), None, 0.5, device="cpu")
    with pytest.raises(ValueError, match="use_fused=True"):
        KeyWordSpotter(str(ckpt), configs, str(tokens), None, 0.5,
                       use_fused=True, device="cpu")


def _keyword_posteriors(spotter, frames, peak, blank):
    def fake_apply(feats, cache):
        t = feats.shape[1]
        probs = np.full((1, t, 4), 0.001, np.float32)
        probs[:, :, 0] = 0.9
        for i in range(t):
            absolute = spotter._frame_indices[i]
            if absolute in frames:
                probs[0, i, 0] = blank
                probs[0, i, frames[absolute]] = peak
        return probs, cache

    return fake_apply


@pytest.mark.parametrize("threshold,peak,blank,fires", [
    (0.3, 0.9, 0.05, True),    # 'h' at frame 10, 'i' at frame 30
    (0.99, 0.6, 0.3, False),   # sqrt(0.6 * 0.6) < 0.99: the gate blocks
])
def test_detector_on_injected_posteriors_matches_jax(setup, threshold, peak,
                                                     blank, fires):
    """The model step replaced by posteriors spelling the keyword: the
    FSM fires (or the threshold gate blocks) with identical results in
    both packages."""
    jax_ckpt, port_ckpt, config, tokens = setup
    jspot = JaxKeyWordSpotter(jax_ckpt, config, tokens, None,
                              threshold=threshold, min_frames=1,
                              max_frames=250)
    pspot = KeyWordSpotter(port_ckpt, config, tokens, None,
                           threshold=threshold, min_frames=1, max_frames=250,
                           device="cpu")
    runs = []
    for spot in (jspot, pspot):
        spot.set_keywords("hi")
        spot._apply = _keyword_posteriors(spot, {10: 1, 30: 2}, peak, blank)
        pcm = np.zeros(16000, "<i2").tobytes()
        runs.append([spot.forward(pcm[off:off + 9600])
                     for off in range(0, len(pcm), 9600)])
    assert runs[0] == runs[1]
    hits = [r for r in runs[1] if r and r.get("state") == 1]
    assert bool(hits) == fires
    if fires:
        assert hits[0]["keyword"] == "hi"
        assert abs(hits[0]["start"] - 0.10) < 0.02
        assert abs(hits[0]["end"] - 0.30) < 0.02
        assert hits[0]["score"] > 0.5
        assert pspot.detector.activation_frame == \
            jspot.detector.activation_frame == 30


def _seeded_posteriors(rng, t=60, v=6):
    """Peaky posteriors so prefixes grow, repeat and merge."""
    logits = rng.standard_normal((t, v)) * 2.0
    logits[:, 0] += 1.0  # blank is the likeliest token, as in a CTC model
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    return (probs / probs.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("tokenset", [None, {0, 1, 2, 3}])
def test_prefix_beam_equals_jax_exactly(rng, tokenset):
    # short: path probabilities are not renormalised, and the
    # repeat/blank branches drop below 1e-6 after a few dozen frames
    probs = _seeded_posteriors(rng, t=16)
    want = jax_beam_search(probs, keywords_tokenset=tokenset)
    got = ctc_prefix_beam_search(probs, keywords_tokenset=tokenset)
    assert got == want and len(got) > 1
    jb, pb = JaxBeam(tokenset, 3, 20), PrefixBeam(tokenset, 3, 20)
    for frame in probs:
        jb.step(frame)
        pb.step(frame)
        assert pb.cur_hyps == jb.cur_hyps
    assert pb.hypotheses() == jb.hypotheses()
    assert got == ctc_prefix_beam_search(probs, length=16,
                                         keywords_tokenset=tokenset)
    for main, check in (([1, 2, 3], [2, 3]), ([1, 2], [1, 2, 3]),
                        ([4, 1, 2], [1, 2]), ([1, 3, 2], [1, 2]), ([], [])):
        assert is_sublist(main, check) == jax_sublist(main, check)


def test_stream_detector_equals_jax_on_seeded_posteriors(rng):
    """Both detectors over the same seeded posteriors, chunk by chunk."""
    args = (0.05, 1, 250, 5, 3, 20, 0.01, 1)
    jd, pd = JaxDetector(*args), StreamDetector(*args)
    table = {"<blk>": 0, "h": 1, "i": 2, "x": 3}
    for det in (jd, pd):
        det.set_tables(*build_keyword_tables("hi,x", table, {}))
    probs = _seeded_posteriors(rng, t=120, v=4)
    fired = 0
    for s in range(0, 120, 10):
        idx = np.arange(s, s + 10)
        want = jd.process(idx, probs[s:s + 10])
        got = pd.process(idx, probs[s:s + 10])
        assert got == want
        fired += int(bool(got) and got["state"] == 1)
    assert fired > 0 and pd.total_frames == jd.total_frames == 120


def test_tokenizer_equals_jax(tmp_path):
    tokens = tmp_path / "tokens.txt"
    tokens.write_text("<blk> 0\n<filler> 1\nh 2\ni 3\n你 4\n好 5\nhello 6\n"
                      "<unk> 7\nbad line here\n")
    lexicon = tmp_path / "lexicon.txt"
    lexicon.write_text("hi h i\nworld h i h\nlonely\n")
    assert tok.read_token(str(tokens)) == jax_tok.read_token(str(tokens))
    assert (tok.read_lexicon(str(lexicon))
            == jax_tok.read_lexicon(str(lexicon)))
    table, lex = tok.read_token(str(tokens)), tok.read_lexicon(str(lexicon))
    for text in ("hi", "你好 hello", "Hi,world", "zz你", "hello你 好world"):
        assert tok.split_mixed_label(text) == jax_tok.split_mixed_label(text)
        assert (tok.query_token_set(text, table, lex)
                == jax_tok.query_token_set(text, table, lex))
        assert (build_keyword_tables(text, table, lex)
                == jax_build_keyword_tables(text, table, lex))
    pt = tok.CharTokenizer(str(tokens), str(lexicon))
    jt = jax_tok.CharTokenizer(str(tokens), str(lexicon))
    for text in ("hi你好", "world zz"):
        assert pt.tokenize(text) == jt.tokenize(text)
    assert pt.vocab_size == jt.vocab_size == 8
    assert pt.detokenize([2, 3, 99]) == jt.detokenize([2, 3, 99])
    assert (pt.keyword_token_set(["hi", "你好"])
            == jt.keyword_token_set(["hi", "你好"]))
