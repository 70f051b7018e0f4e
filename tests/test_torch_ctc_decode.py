"""The port's CTC decoders (wekws_tpu_torch.decode) against the JAX
package's on the same numpy inputs: greedy decode, the batched edit
distance and token accuracy, the Calculator, acc_utterance and the
batched prefix beam search (the cases of tests/test_batched_ctc.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wekws_tpu import decode as jd
from wekws_tpu.decode.batched_ctc import (
    batched_ctc_prefix_beam_search as jax_batched,
)
from wekws_tpu.eval.score_ctc import detect_keyword as jax_detect
from wekws_tpu_torch import decode as pd
from wekws_tpu_torch.decode.batched_ctc import _wrap_int32
from wekws_tpu_torch.eval import detect_keyword


def _greedy_case(rng, b=6, t=20, v=5):
    """Logits whose argmax runs have repeats, blanks and ties (small
    integers), ragged lengths (one row empty), ragged references."""
    logits = rng.integers(0, 3, (b, t, v)).astype(np.float32)
    lengths = rng.integers(0, t + 1, (b,))
    lengths[0], lengths[1] = 0, t
    refs = rng.integers(1, v, (b, 7))
    ref_lengths = rng.integers(0, 8, (b,))
    return logits, lengths, refs, ref_lengths


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_decode_and_token_accuracy_equal_jax(seed):
    """Hypotheses, their lengths, edit distances and accuracies exactly
    equal to the JAX package's (argmax ties to the first index in
    both)."""
    logits, lengths, refs, ref_lengths = _greedy_case(
        np.random.default_rng(seed))
    hj, lj = jd.ctc_greedy_decode(jnp.asarray(logits), jnp.asarray(lengths))
    hp, lp = pd.ctc_greedy_decode(torch.from_numpy(logits),
                                  torch.from_numpy(lengths))
    np.testing.assert_array_equal(hp.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    dj = jax.jit(jd.batched_edit_distance)(hj, lj, jnp.asarray(refs),
                                           jnp.asarray(ref_lengths))
    dp = pd.batched_edit_distance(hp, lp, torch.from_numpy(refs),
                                  torch.from_numpy(ref_lengths))
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    aj = jax.jit(jd.ctc_token_accuracy)(
        jnp.asarray(logits), jnp.asarray(refs), jnp.asarray(lengths),
        jnp.asarray(ref_lengths))
    ap = pd.ctc_token_accuracy(
        torch.from_numpy(logits), torch.from_numpy(refs),
        torch.from_numpy(lengths), torch.from_numpy(ref_lengths))
    np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))


def test_calculator_and_acc_utterance_equal_jax():
    """Per-call results and per-token counters of the Calculator over
    random token strings, and acc_utterance over random posteriors,
    equal to the JAX package's."""
    rng = np.random.default_rng(3)
    cj, cp = jd.Calculator(), pd.Calculator()
    for _ in range(30):
        lab = [str(x) for x in rng.integers(0, 5, rng.integers(0, 7))]
        rec = [str(x) for x in rng.integers(0, 5, rng.integers(0, 7))]
        assert cp.calculate(lab, rec) == cj.calculate(lab, rec)
    assert cp.data == cj.data and cp.overall() == cj.overall()
    assert cp.cluster(["1", "3", "x"]) == cj.cluster(["1", "3", "x"])
    probs = rng.dirichlet(np.ones(6) * 0.3, size=(5, 18)).astype(np.float32)
    target = rng.integers(1, 6, (5, 4))
    args = (probs, target, [18, 12, 18, 5, 9], [4, 3, 0, 2, 4])
    assert pd.acc_utterance(*args) == jd.acc_utterance(*args)


def _spelled(seq, v, peak=0.9):
    p = np.full((len(seq), v), (1 - peak) / (v - 1), np.float32)
    for t, s in enumerate(seq):
        p[t, s] = peak
    return p


def _both(probs, lengths, **kw):
    """(port result as numpy arrays, JAX result as numpy arrays)."""
    mask = kw.pop("tokenset_mask", None)
    got = pd.batched_ctc_prefix_beam_search(
        torch.from_numpy(probs), torch.from_numpy(np.asarray(lengths)),
        tokenset_mask=None if mask is None else torch.from_numpy(mask), **kw)
    want = jax_batched(jnp.asarray(probs), jnp.asarray(lengths),
                       tokenset_mask=None if mask is None
                       else jnp.asarray(mask), **kw)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def _assert_same_arrays(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if want[key].dtype.kind == "f":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_batched_spelled_sequences_exact():
    """Spelled sequences: the best hypothesis, its score (1e-4 rel) and
    its timestamps equal the host decoder's; every array equal to the
    JAX package's."""
    v = 6
    seqs = [[0, 1, 1, 0, 2], [3, 0, 3, 0, 3], [0, 0, 0, 0, 0],
            [4, 4, 0, 4, 4]]
    probs = np.stack([_spelled(s, v) for s in seqs])
    lengths = np.full(len(seqs), 5, np.int32)
    got, want = _both(probs, lengths, path_beam=8)
    _assert_same_arrays(got, want)
    for i in range(len(seqs)):
        host = pd.ctc_prefix_beam_search(probs[i], 5, None, 3, 8)
        hyps = pd.hyps_from_arrays(got, i)
        assert hyps[0][0] == host[0][0]
        np.testing.assert_allclose(hyps[0][1], host[0][1], rtol=1e-4)
        for gn, wn in zip(hyps[0][2], host[0][2]):
            assert (gn["token"], gn["frame"]) == (wn["token"], wn["frame"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_random_posteriors_match_host_and_jax(seed):
    """Dirichlet posteriors with ragged lengths: every array equal to
    the JAX package's (floats 1e-6 rel); the best prefix and score
    (1e-3 rel) the host decoder's, and every host hypothesis within 1e-3
    of the top score present with its score."""
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(8) * 0.4, size=(4, 16)).astype(np.float32)
    lengths = np.array([16, 12, 16, 9], np.int32)
    got, want = _both(probs, lengths, path_beam=20)
    _assert_same_arrays(got, want)
    for i in range(4):
        host = pd.ctc_prefix_beam_search(probs[i], int(lengths[i]), None,
                                         3, 20)
        hyps = pd.hyps_from_arrays(got, i)
        assert hyps[0][0] == host[0][0]
        np.testing.assert_allclose(hyps[0][1], host[0][1], rtol=1e-3)
        scores = {h[0]: h[1] for h in hyps}
        for prefix, score, _ in host:
            if score >= host[0][1] * 1e-3:
                np.testing.assert_allclose(scores[prefix], score, rtol=1e-3)


def test_batched_tokenset_and_keyword_detection():
    """Token-set pruning and the keyword matcher on the batched result,
    as the JAX package's tests hold them, and equal to JAX's."""
    v = 6
    probs = np.stack([_spelled([0, 1, 0, 5, 0, 2], v)])
    mask = np.zeros(v, bool)
    mask[[0, 1, 2]] = True
    got, want = _both(probs, np.asarray([6]), tokenset_mask=mask)
    _assert_same_arrays(got, want)
    assert pd.hyps_from_arrays(got, 0)[0][0] == (1, 2)
    probs = np.stack([_spelled([0, 1, 1, 0, 2, 0], v, peak=0.95)])
    got, want = _both(probs, np.asarray([6]))
    kw = {"kw": {"token_id": (1, 2), "token_str": "1 2"}}
    hit = detect_keyword(pd.hyps_from_arrays(got, 0), kw)
    assert hit == jax_detect(pd.hyps_from_arrays(want, 0), kw)
    word, score, start, end = hit
    assert word == "kw" and score > 0.9 and start in (1, 2) and end == 4


def test_prefix_hash_wraps_like_int32():
    """The rolling hash folded to 32 bits equals int32 arithmetic that
    wraps, over prefixes long enough to overflow many times."""
    rng = np.random.default_rng(5)
    toks = rng.integers(-1, 3000, (64, 40))
    want = np.zeros(64, np.int32)
    got = torch.zeros(64, dtype=torch.int64)
    with np.errstate(over="ignore"):
        for i in range(toks.shape[1]):
            want = want * np.int32(1000003) + (toks[:, i] + 2).astype(
                np.int32)
            got = _wrap_int32(got * 1000003 + torch.from_numpy(toks[:, i]
                                                               + 2))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
