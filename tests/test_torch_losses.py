"""Port losses (wekws_tpu_torch.losses) against the JAX package's on
the same numpy inputs: values, accuracies and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
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


def test_ctc_raises():
    x = torch.zeros((2, 5, 3))
    lengths = torch.tensor([5, 5])
    for fn in (pl.criterion, pl.criterion_per_utt):
        with pytest.raises(NotImplementedError, match="item 8"):
            fn("ctc", x, torch.zeros((2, 2), dtype=torch.long), lengths,
               torch.tensor([2, 2]))
