"""Training criteria: max-pooling, cross-entropy and CTC.

Port of wekws_tpu/losses/losses.py: masked reductions over the
(B, T, K) posteriors instead of the reference's per-utterance loop.
Maxima and minima over time use ``torch.amax`` / ``torch.amin``, which
split the gradient evenly among tied frames as JAX's ``max`` does
(``torch.max(dim)`` would send it all to one index).  CTC is the
compact recursion of ``ctc_compact``; its accuracy is 0 in training and
the greedy token accuracy per utterance in cv (``criterion_per_utt``).
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from wekws_tpu_torch.losses.ctc_compact import ctc_loss_compact
from wekws_tpu_torch.losses.mask import padding_mask


def max_pooling_per_utt(
    logits: torch.Tensor,
    target: torch.Tensor,
    lengths: torch.Tensor,
    min_duration: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-utterance (loss, correct) vectors; see ``max_pooling_loss``."""
    b, t, k = logits.shape
    pad = padding_mask(lengths, t)
    pos = torch.arange(t, device=logits.device)[None, :]
    pos_mask = pad | (pos < min_duration)
    zero = logits.new_zeros(())
    one = logits.new_ones(())
    pos_prob = torch.where(pos_mask[:, :, None], zero, logits)
    max_prob = torch.clamp(torch.amax(pos_prob, dim=1), 1e-8, 1.0)
    pos_loss = -torch.log(max_prob)

    neg_prob = torch.where(pad[:, :, None], one, 1.0 - logits)
    min_prob = torch.clamp(torch.amin(neg_prob, dim=1), 1e-8, 1.0)
    neg_loss = -torch.log(min_prob)

    is_target = target[:, None] == torch.arange(k, device=logits.device)[None]
    loss_b = torch.sum(torch.where(is_target, pos_loss, neg_loss), dim=1)

    masked = torch.where(pad[:, :, None], zero, logits)
    peak = torch.amax(masked, dim=1)
    max_p = torch.amax(peak, dim=1)
    idx = torch.argmax(peak, dim=1)
    correct = ((max_p > 0.5) & (idx == target)) | (
        (max_p < 0.5) & (target < 0))
    return loss_b, correct.to(torch.float32)


def max_pooling_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    lengths: torch.Tensor,
    min_duration: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max-pooling wake-word loss over sigmoid posteriors (B, T, K).

    For the labeled keyword: -log(max prob) over valid frames after
    ``min_duration``; for every other keyword (all keywords of a filler
    utterance, ``target < 0``): -log(min(1 - prob)).  Clamped to
    [1e-8, 1]; masked frames read 0.0 on the positive path and 1.0 on
    the negative.  Returns (scalar loss, scalar accuracy)."""
    loss_b, correct = max_pooling_per_utt(logits, target, lengths,
                                          min_duration)
    return loss_b.mean(), correct.mean()


def acc_frame(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Classification accuracy in percent."""
    pred = torch.argmax(logits, dim=-1)
    return (pred == target).to(torch.float32).mean() * 100.0


def cross_entropy(logits: torch.Tensor, target: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE over utterance logits (B, K)."""
    loss = F.cross_entropy(logits, target.long())
    return loss, acc_frame(logits, target)


def _ctc_per_utt(logits, target, lengths, target_lengths, blank_id=0):
    t, u = logits.shape[1], target.shape[1]
    logit_pad = padding_mask(lengths, t).to(torch.float32)
    label_pad = padding_mask(target_lengths, u).to(torch.float32)
    return ctc_loss_compact(logits, logit_pad, target, label_pad,
                            blank_id=blank_id)


def ctc_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    logit_lengths: torch.Tensor,
    target_lengths: torch.Tensor,
    blank_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CTC loss over raw frame logits (B, T, V) and padded label ids
    (B, U): (batch mean of the per-utterance losses, 0.0).  Decode
    accuracy is computed in cv only."""
    per_seq = _ctc_per_utt(logits, target, logit_lengths, target_lengths,
                           blank_id)
    return per_seq.mean(), logits.new_zeros((), dtype=torch.float32)


def criterion(
    loss_type: str,
    logits: torch.Tensor,
    target: torch.Tensor,
    lengths: torch.Tensor,
    target_lengths: Optional[torch.Tensor] = None,
    min_duration: int = 0,
    valid: Optional[torch.Tensor] = None,
    valid_total: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on 'ce' | 'max_pooling' | 'ctc'.  ``valid`` (B,) 0/1
    leaves filler rows out of the loss mean and the accuracy.
    ``valid_total`` replaces ``valid.sum()`` as the denominator: under
    data parallelism the global batch's count, so that the ranks' losses
    (and gradients) sum to the global batch's."""
    if valid is not None:
        valid = valid.to(torch.float32)
        n = torch.clamp(valid.sum() if valid_total is None else valid_total,
                        min=1.0)
        if loss_type == "ctc":
            # no greedy decode in the training step: its accuracy is 0
            loss_b = _ctc_per_utt(logits, target, lengths, target_lengths)
            return (loss_b * valid).sum() / n, valid.new_zeros(())
        loss_b, correct_b = criterion_per_utt(
            loss_type, logits, target, lengths, target_lengths, min_duration)
        loss = (loss_b * valid).sum() / n
        acc = (correct_b * valid).sum() / n
        if loss_type == "ce":
            acc = acc * 100.0
        return loss, acc
    if loss_type == "ce":
        return cross_entropy(logits, target)
    if loss_type == "max_pooling":
        return max_pooling_loss(logits, target, lengths, min_duration)
    if loss_type == "ctc":
        return ctc_loss(logits, target, lengths, target_lengths)
    raise ValueError(f"unknown criterion {loss_type}")


def criterion_per_utt(
    loss_type: str,
    logits: torch.Tensor,
    target: torch.Tensor,
    lengths: torch.Tensor,
    target_lengths: Optional[torch.Tensor] = None,
    min_duration: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-utterance (loss, correct) vectors for exact cv accounting."""
    if loss_type == "ce":
        loss_b = F.cross_entropy(logits, target.long(), reduction="none")
        correct = (torch.argmax(logits, dim=-1) == target).to(torch.float32)
        return loss_b, correct
    if loss_type == "max_pooling":
        return max_pooling_per_utt(logits, target, lengths, min_duration)
    if loss_type == "ctc":
        # the cv signal: greedy decode + token accuracy per utterance
        from wekws_tpu_torch.decode.greedy import ctc_token_accuracy

        loss_b = _ctc_per_utt(logits, target, lengths, target_lengths)
        return loss_b, ctc_token_accuracy(logits, target, lengths,
                                          target_lengths)
    raise ValueError(f"unknown criterion {loss_type}")
