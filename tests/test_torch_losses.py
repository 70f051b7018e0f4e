"""Port losses (wekws_tpu_torch.losses) against the JAX package's on
the same numpy inputs: values, accuracies and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wekws_tpu import losses as jl
from wekws_tpu_torch import losses as pl

TARGET = np.array([0, 1, 2, -1, -1, 1], np.int64)
LENGTHS = np.array([40, 35, 20, 40, 10, 40], np.int64)


def _logits(rng, ties=False):
    x = rng.uniform(0.01, 0.99, (6, 40, 3)).astype(np.float32)
    if ties:
        # tied maxima and minima: JAX splits their gradient evenly,
        # torch.amax / amin must do the same
        x[:, 7, :] = x[:, 3, :] = 0.999
        x[3, 1, :] = x[3, 2, :] = 0.001
    return x


def test_padding_mask():
    got = pl.padding_mask(torch.tensor([2, 0, 3]), 3)
    want = jl.padding_mask(jnp.asarray([2, 0, 3]), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("min_duration", [0, 5])
@pytest.mark.parametrize("ties", [False, True])
def test_max_pooling_value_and_grad(rng, min_duration, ties):
    """Padded rows, min_duration and ties: loss 1e-6 rel, accuracy
    exact, gradient 1e-6 abs (float32, same formulas)."""
    x = _logits(rng, ties)

    def jax_loss(z):
        return jl.max_pooling_loss(z, jnp.asarray(TARGET, jnp.int32),
                                   jnp.asarray(LENGTHS, jnp.int32),
                                   min_duration)

    (want, want_acc), want_g = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got, got_acc = pl.max_pooling_loss(xt, torch.from_numpy(TARGET),
                                       torch.from_numpy(LENGTHS),
                                       min_duration)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert float(got_acc) == float(want_acc)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               atol=1e-6)
    loss_b, correct = pl.max_pooling_per_utt(
        xt.detach(), torch.from_numpy(TARGET), torch.from_numpy(LENGTHS),
        min_duration)
    jloss_b, jcorrect = jl.max_pooling_per_utt(
        jnp.asarray(x), jnp.asarray(TARGET), jnp.asarray(LENGTHS),
        min_duration)
    np.testing.assert_allclose(loss_b.numpy(), np.asarray(jloss_b),
                               rtol=1e-6)
    np.testing.assert_array_equal(correct.numpy(), np.asarray(jcorrect))


def test_cross_entropy_and_acc_frame(rng):
    """CE value 1e-6 rel and gradient 1e-6 abs; accuracy in percent."""
    x = rng.standard_normal((8, 5)).astype(np.float32)
    t = rng.integers(0, 5, 8)

    def jax_loss(z):
        return jl.cross_entropy(z, jnp.asarray(t, jnp.int32))

    (want, want_acc), want_g = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got, got_acc = pl.cross_entropy(xt, torch.from_numpy(t))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(got_acc), float(want_acc), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               atol=1e-6)


@pytest.mark.parametrize("loss_type", ["max_pooling", "ce"])
def test_criterion_with_valid_rows(rng, loss_type):
    """``valid`` leaves filler rows out of loss and accuracy: 1e-6 rel;
    per-utterance vectors the same."""
    valid = np.array([1, 1, 0, 1, 0, 1], np.float32)
    if loss_type == "ce":
        x = rng.standard_normal((6, 3)).astype(np.float32)
        t = np.array([0, 1, 2, 0, 1, 2], np.int64)
    else:
        x, t = _logits(rng), TARGET
    args_j = (jnp.asarray(x), jnp.asarray(t, jnp.int32),
              jnp.asarray(LENGTHS, jnp.int32))
    args_p = (torch.from_numpy(x), torch.from_numpy(t),
              torch.from_numpy(LENGTHS))
    for valid_j, valid_p in ((None, None),
                             (jnp.asarray(valid), torch.from_numpy(valid))):
        want = jl.criterion(loss_type, *args_j, None, 3, valid=valid_j)
        got = pl.criterion(loss_type, *args_p, None, 3, valid=valid_p)
        for a, b in zip(got, want):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    for a, b in zip(pl.criterion_per_utt(loss_type, *args_p, None, 3),
                    jl.criterion_per_utt(loss_type, *args_j, None, 3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _ctc_case(rng, b, t, v, u, repeated=False):
    """tests/test_losses.py's CTC case: random logits, ragged frame and
    label paddings, every row feasible."""
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    t_lens = rng.integers(max(2 * u + 2, t // 2), t + 1, (b,))
    u_lens = rng.integers(1, u + 1, (b,))
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    if repeated:
        labels[:, 1::2] = labels[:, 0:1]  # force repeats
    logit_pad = (np.arange(t)[None, :] >= t_lens[:, None]).astype(np.float32)
    label_pad = (np.arange(u)[None, :] >= u_lens[:, None]).astype(np.float32)
    return logits, logit_pad, labels, label_pad


def _ctc_both(logits, logit_pad, labels, label_pad, rows=None):
    """(JAX per-row loss, JAX gradient of the summed loss of ``rows``,
    port per-row loss, port gradient of the same)."""
    from wekws_tpu.losses.ctc_compact import ctc_loss_compact as jctc

    from wekws_tpu_torch.losses import ctc_loss_compact

    rows = np.arange(len(logits)) if rows is None else np.asarray(rows)
    args = [jnp.asarray(a) for a in (logit_pad, labels, label_pad)]
    want = jax.jit(jctc)(jnp.asarray(logits), *args)
    want_g = jax.jit(jax.grad(lambda z, *a: jctc(z, *a)[rows].sum()))(
        jnp.asarray(logits), *args)
    x = torch.from_numpy(logits).requires_grad_()
    got = ctc_loss_compact(x, torch.from_numpy(logit_pad),
                           torch.from_numpy(labels),
                           torch.from_numpy(label_pad))
    got[torch.from_numpy(rows)].sum().backward()
    return (np.asarray(want), np.asarray(want_g), got.detach().numpy(),
            x.grad.numpy())


@pytest.mark.parametrize("repeated", [False, True])
def test_ctc_compact_matches_jax_and_optax(rng, repeated):
    """Feasible rows with repeated labels and ragged paddings: values
    1e-5 rel and gradients 2e-5 abs against the JAX function (the pins
    of tests/test_losses.py against optax), values 1e-5 rel against
    optax.ctc_loss."""
    case = _ctc_case(rng, b=5, t=37, v=29, u=6, repeated=repeated)
    want, want_g, got, got_g = _ctc_both(*case)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-5)
    np.testing.assert_allclose(got_g, want_g, atol=2e-5)
    ref = optax.ctc_loss(*[jnp.asarray(a) for a in case])
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5)


def test_ctc_compact_edge_cases_match_jax(rng):
    """Empty label rows (pure blank), T == U (no blank between labels),
    a single frame and label, a row without frames (loss 0, gradient
    0): 1e-5 rel values, 2e-5 abs gradients, every gradient finite."""
    cases = []
    logits = rng.standard_normal((3, 9, 7)).astype(np.float32)
    label_pad = np.asarray([[1, 1, 1], [0, 1, 1], [0, 0, 1]], np.float32)
    logit_pad = np.zeros((3, 9), np.float32)
    logit_pad[2, 5:] = 1.0
    cases.append((logits, logit_pad, np.ones((3, 3), np.int32), label_pad))
    zeros4 = np.zeros((1, 4), np.float32)
    cases.append((rng.standard_normal((1, 4, 6)).astype(np.float32), zeros4,
                  np.asarray([[1, 2, 3, 4]], np.int32), zeros4))
    z1 = np.zeros((1, 1), np.float32)
    cases.append((rng.standard_normal((1, 1, 5)).astype(np.float32), z1,
                  np.asarray([[2]], np.int32), z1))
    no_frames = np.zeros((2, 6), np.float32)
    no_frames[1] = 1.0
    cases.append((rng.standard_normal((2, 6, 5)).astype(np.float32),
                  no_frames, np.asarray([[1, 3], [2, 2]], np.int32),
                  np.zeros((2, 2), np.float32)))
    for case in cases:
        want, want_g, got, got_g = _ctc_both(*case)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_g, want_g, atol=2e-5)
        assert np.isfinite(got_g).all()
    assert got[1] == 0.0 and not got_g[1].any()


def test_ctc_infeasible_rows_on_optax_scale(rng):
    """Rows whose labels need more frames than they have: finite and on
    optax's scale (the port's floor is optax's log-epsilon; the JAX
    function returns about 1e30 there), 1e-4 rel of optax.ctc_loss; the
    feasible row's value and the other rows' gradients unchanged
    (1e-5 rel, 2e-5 abs against the JAX function)."""
    b, t, v, u = 4, 3, 7, 4
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    label_pad = np.zeros((b, u), np.float32)
    label_pad[0, 1:] = 1.0  # row 0 feasible: one label in three frames
    logit_pad = np.zeros((b, t), np.float32)
    want, want_g, got, _ = _ctc_both(logits, logit_pad, labels, label_pad,
                                     rows=[0])
    ref = np.asarray(optax.ctc_loss(*[jnp.asarray(a) for a in (
        logits, logit_pad, labels, label_pad)]))
    assert np.isfinite(got).all() and (want[1:] > 1e29).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-4)
    assert (got[1:] > 9e4).all()
    x = torch.from_numpy(logits).requires_grad_()
    from wekws_tpu_torch.losses import ctc_loss_compact

    ctc_loss_compact(x, torch.from_numpy(logit_pad),
                     torch.from_numpy(labels),
                     torch.from_numpy(label_pad)).sum().backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy()[0], want_g[0], atol=2e-5)


@pytest.mark.parametrize("with_valid", [False, True])
def test_ctc_criterion_matches_jax(rng, with_valid):
    """criterion('ctc') with and without ``valid`` (loss 1e-5 rel,
    accuracy 0) and criterion_per_utt('ctc') (per-utterance loss 1e-5
    rel, greedy token accuracy exact), label pads of -1 as the data
    pipeline writes them."""
    logits, logit_pad, labels, label_pad = _ctc_case(rng, b=6, t=30, v=9,
                                                     u=5)
    labels = np.where(label_pad > 0, -1, labels).astype(np.int64)
    lengths = (1 - logit_pad).sum(1).astype(np.int64)
    target_lengths = (1 - label_pad).sum(1).astype(np.int64)
    valid = np.array([1, 1, 0, 1, 0, 1], np.float32)
    args_j = [jnp.asarray(a) for a in (logits, labels, lengths,
                                       target_lengths)]
    args_p = [torch.from_numpy(a) for a in (logits, labels, lengths,
                                           target_lengths)]
    vj, vp = ((jnp.asarray(valid), torch.from_numpy(valid)) if with_valid
              else (None, None))
    want = jax.jit(lambda *a: jl.criterion("ctc", *a, valid=vj))(*args_j)
    got = pl.criterion("ctc", *args_p[:3], args_p[3], valid=vp)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    assert float(got[1]) == float(want[1]) == 0.0
    want_b, want_acc = jax.jit(
        lambda *a: jl.criterion_per_utt("ctc", *a))(*args_j)
    got_b, got_acc = pl.criterion_per_utt("ctc", *args_p[:3], args_p[3])
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-5)
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
