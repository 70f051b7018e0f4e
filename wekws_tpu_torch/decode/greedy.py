"""Greedy CTC decode and batched token accuracy on the device.

Port of wekws_tpu/decode/greedy.py: the cv-quality signal that rides
along with every CTC cv step, with fixed shapes and no host round trip.

* greedy decode: per-frame argmax -> collapse repeats -> drop blanks;
  survivors are compacted to the front by a stable argsort of the
  keep-mask;
* token accuracy: batched Levenshtein distance, one row update per
  hypothesis position, with the insertion chain folded in by the
  min-plus trick ``new_row = cummin(cand - j) + j``.

Accuracy per utterance is ``(ref_len - edit_distance) / ref_len``, 0 for
an empty reference.
"""

from typing import Tuple

import torch

from wekws_tpu_torch.losses.mask import padding_mask


def ctc_greedy_decode(
    logits: torch.Tensor,
    lengths: torch.Tensor,
    blank_id: int = 0,
    pad_id: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, V) frame logits (or log-probs: only argmax is used) and
    (B,) frame counts -> ((B, T) token ids compacted to the front and
    padded with ``pad_id``, (B,) counts)."""
    b, t, _ = logits.shape
    ids = torch.argmax(logits, dim=-1)
    valid = ~padding_mask(lengths, t)
    prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype,
                                 device=ids.device), ids[:, :-1]], dim=1)
    keep = valid & (ids != blank_id) & (ids != prev)
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    hyps = torch.gather(ids, 1, order)
    hyp_lengths = keep.sum(dim=1)
    pos = torch.arange(t, device=ids.device)[None, :]
    hyps = torch.where(pos < hyp_lengths[:, None], hyps,
                       torch.full((), pad_id, dtype=ids.dtype,
                                  device=ids.device))
    return hyps, hyp_lengths


def batched_edit_distance(
    hyps: torch.Tensor,
    hyp_lengths: torch.Tensor,
    refs: torch.Tensor,
    ref_lengths: torch.Tensor,
) -> torch.Tensor:
    """Levenshtein distance per row: (B, T) hypotheses (padding past
    ``hyp_lengths`` ignored), (B, U) references -> (B,) int32."""
    b, t = hyps.shape
    u = refs.shape[1]
    dev = hyps.device
    j = torch.arange(u + 1, device=dev, dtype=torch.int32)[None, :]
    row = j.expand(b, u + 1)
    refs = refs.to(torch.int32)
    active = torch.arange(t, device=dev)[None, :] < hyp_lengths[:, None]
    for i in range(t):
        sub_cost = (hyps[:, i:i + 1].to(torch.int32) != refs).to(torch.int32)
        # best before insertions: delete the hyp token, or match /
        # substitute it against column j
        cand = torch.cat([row[:, :1] + 1,
                          torch.minimum(row[:, 1:] + 1,
                                        row[:, :-1] + sub_cost)], dim=1)
        new_row = torch.cummin(cand - j, dim=1).values + j
        row = torch.where(active[:, i:i + 1], new_row, row)
    return torch.gather(row, 1, ref_lengths.to(torch.int64)[:, None])[:, 0]


def ctc_token_accuracy(
    logits: torch.Tensor,
    target: torch.Tensor,
    logit_lengths: torch.Tensor,
    target_lengths: torch.Tensor,
    blank_id: int = 0,
) -> torch.Tensor:
    """(B,) float32 greedy token accuracy ``(ref_len - edits) / ref_len``
    (negative where insertions dominate, as the reference's formula);
    0 for an empty reference."""
    hyps, hyp_lengths = ctc_greedy_decode(logits, logit_lengths, blank_id)
    dist = batched_edit_distance(hyps, hyp_lengths, target, target_lengths)
    ref_len = target_lengths.to(torch.float32)
    acc = (ref_len - dist.to(torch.float32)) / torch.clamp(ref_len, min=1.0)
    return torch.where(target_lengths > 0, acc, torch.zeros_like(acc))
