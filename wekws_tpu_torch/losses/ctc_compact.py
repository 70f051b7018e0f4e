"""Compact CTC loss: the forward-alpha recursion on label columns only.

Port of wekws_tpu/losses/ctc_compact.py.  CTC only ever reads the
vocabulary axis through the per-frame normaliser and the 2U+1
extended-label columns, so V is reduced first:

    lse  = logsumexp(logits, -1)                       (B, T)
    lbl  = gather(logits, label ids)                   (B, T, U)
    logp = lbl - lse  (and the blank column)

and the standard alpha recursion runs over the (B, 2U+1) extended
labels, frame by frame, in log space.  Plain PyTorch with autograd: the
JAX package computes it outside any Pallas kernel.  ``torch.gather`` of
the label columns gives exactly the values of the JAX one-hot product
(an id outside [0, V), a label pad, reads 0 as its one-hot row does).

One departure from the JAX function: the floor of the log-space
recursion is optax's log-epsilon, -1e5, not -1e30.  A row whose labels
need more frames than it has (2U' + 1 > T' with U' repeats counted)
then comes out finite, near 1e5, on ``optax.ctc_loss``'s scale, where
the JAX function returns about 1e30.  Feasible rows are unchanged: the
floor's terms underflow to 0 beside any real path.  A row without
frames gives 0, as in the JAX function.  Every ``exp`` argument is <= 0
(each term minus the largest), so no gradient is NaN on padded frames
or on rows whose labels are all padding.
"""

import torch

# optax.ctc_loss's log_epsilon: the log-probability of an unreachable state
_NEG = -1e5


def ctc_loss_compact(
    logits: torch.Tensor,          # (B, T, V)
    logit_paddings: torch.Tensor,  # (B, T) 1.0 = pad
    labels: torch.Tensor,          # (B, U) int
    label_paddings: torch.Tensor,  # (B, U) 1.0 = pad
    blank_id: int = 0,
) -> torch.Tensor:
    """Per-sequence negative log likelihood, shape (B,), float32 (or the
    logits' dtype when that is float64)."""
    b, t, v = logits.shape
    u = labels.shape[1]
    s = 2 * u + 1
    dev = logits.device
    dtype = torch.float64 if logits.dtype == torch.float64 else torch.float32
    x = logits.to(dtype)

    # the V-space reduction: the only passes over the big tensor
    lse = torch.logsumexp(x, dim=-1)                           # (B, T)
    ids = labels.to(torch.int64)
    in_range = (ids >= 0) & (ids < v)
    lbl = torch.gather(x, 2, ids.clamp(0, v - 1)[:, None, :].expand(b, t, u))
    lbl = torch.where(in_range[:, None, :], lbl, torch.zeros((), dtype=dtype,
                                                              device=dev))
    logp_lbl = lbl - lse[..., None]                            # (B, T, U)
    logp_blank = x[..., blank_id] - lse                        # (B, T)

    # emissions in extended-label order [blank, l1, blank, ..., lU, blank]
    em = torch.cat([
        torch.stack([logp_blank[..., None].expand(b, t, u), logp_lbl],
                    dim=-1).reshape(b, t, 2 * u),
        logp_blank[..., None]], dim=-1)                        # (B, T, S)

    # alpha[s] may come from alpha[s-2] iff z_s is a label that differs
    # from z_{s-2}: an additive 0 / floor mask on the shifted state
    same_as_prev = torch.zeros((b, u), dtype=torch.bool, device=dev)
    same_as_prev[:, 1:] = ids[:, 1:] == ids[:, :-1]
    can_skip = torch.zeros((b, s), dtype=torch.bool, device=dev)
    can_skip[:, 1::2] = ~same_as_prev
    zero = torch.zeros((), dtype=dtype, device=dev)
    neg = torch.full((), _NEG, dtype=dtype, device=dev)
    skip_bias = torch.where(can_skip, zero, neg)

    u_len = (1.0 - label_paddings.to(dtype)).sum(dim=1).to(torch.int64)
    s_len = 2 * u_len + 1                                      # (B,)
    z_valid = torch.arange(s, device=dev)[None, :] < s_len[:, None]
    real = logit_paddings < 0.5                                # (B, T)

    # frame 0: the leading blank, or the first label where there is one
    col = torch.arange(s, device=dev)[None, :]
    start = real[:, 0:1] & ((col == 0) | ((col == 1) & (u_len[:, None] > 0)))
    alpha = torch.where(start, em[:, 0, :], neg)

    # a state off the extended sequence stays at the floor, so updating
    # it only where a frame is real AND the state is valid is the JAX
    # function's two selects in one
    em_sw = em.transpose(0, 1)                                 # (T, B, S)
    upd = (real.transpose(0, 1)[:, :, None] & z_valid[None])   # (T, B, S)
    for f in range(1, t):
        padded = torch.nn.functional.pad(alpha, (2, 0), value=_NEG)
        terms = torch.stack([alpha, padded[:, 1:-1],
                             padded[:, :-2] + skip_bias])
        summed = torch.logsumexp(terms, dim=0)
        alpha = torch.where(upd[f], summed + em_sw[f], alpha)

    # log-likelihood: logsumexp of the last two states of each row
    a1 = torch.gather(alpha, 1, (s_len - 1)[:, None])[:, 0]
    a2 = torch.gather(alpha, 1, (s_len - 2).clamp(min=0)[:, None])[:, 0]
    a2 = torch.where(s_len >= 2, a2, neg)
    ll = torch.logsumexp(torch.stack([a1, a2]), dim=0)
    has_frames = real.any(dim=1)
    return torch.where(has_frames, -ll, zero)
