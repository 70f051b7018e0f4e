"""Batched CTC prefix beam search on the device.

Port of wekws_tpu/decode/batched_ctc.py: a frame-synchronous prefix beam
search over ``(B, T, V)`` posteriors with fixed-size beams, duplicate
prefixes merged by hash-sort and segment sums (``torch.sort`` +
``scatter_add_`` / ``scatter_reduce_``), and per-token {token, frame,
prob} node tracks for keyword timestamps.  The semantics are the host
decoder's (wekws_tpu_torch.decode.ctc_prefix_beam_search), quirks
included:

* first prune: top ``score_beam`` tokens, kept if prob > 0.05 (and in
  the keyword token set when given); a frame where nothing passes leaves
  the beam unchanged;
* the blank transition applies only when blank itself passes the filter;
* a repeated emission moves the last node to its best-scoring frame.

One documented approximation: when two parents merge into one prefix,
the node track of the higher-``pnb`` contributor wins (the host decoder
keeps the first-created track), so scores agree and timestamps can
differ on merged paths.

The rolling prefix hash wraps exactly as the JAX package's int32
product does: it is computed in int64 and folded back to 32-bit two's
complement, so the same candidates merge.  Ties in the top-k choices
and in the final order resolve to the lower index, as ``lax.top_k`` and
the stable ``argsort`` do.  The frames run as a Python loop; scores
stay in probability space, as in the reference.
"""

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

_HASH_MULT = 1000003
_INT32_MIN = -(2 ** 31)


class BeamState(NamedTuple):
    prefixes: torch.Tensor    # (B, W, U) int64, -1 padded
    plen: torch.Tensor        # (B, W) int64
    pb: torch.Tensor          # (B, W) f32 (ends-in-blank prob)
    pnb: torch.Tensor         # (B, W) f32 (ends-in-token prob)
    node_tok: torch.Tensor    # (B, W, U) int64
    node_frame: torch.Tensor  # (B, W, U) int64
    node_prob: torch.Tensor   # (B, W, U) f32
    valid: torch.Tensor       # (B, W) bool
    phash: torch.Tensor       # (B, W) int64 holding int32 values


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value of its low 32 bits."""
    return ((x - _INT32_MIN) & 0xFFFFFFFF) + _INT32_MIN


def _init_state(b: int, w: int, u: int, device) -> BeamState:
    i64 = dict(dtype=torch.int64, device=device)
    first = torch.zeros((b, w), dtype=torch.bool, device=device)
    first[:, 0] = True
    return BeamState(
        prefixes=torch.full((b, w, u), -1, **i64),
        plen=torch.zeros((b, w), **i64),
        pb=first.to(torch.float32),
        pnb=torch.zeros((b, w), dtype=torch.float32, device=device),
        node_tok=torch.full((b, w, u), -1, **i64),
        node_frame=torch.zeros((b, w, u), **i64),
        node_prob=torch.zeros((b, w, u), dtype=torch.float32, device=device),
        valid=first,
        phash=torch.zeros((b, w), **i64),
    )


def _top_k(x: torch.Tensor, k: int):
    """Largest k along dim 1, ties to the lower index."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def batched_ctc_prefix_beam_search(
    probs: torch.Tensor,
    lengths: torch.Tensor,
    tokenset_mask: Optional[torch.Tensor] = None,
    score_beam: int = 3,
    path_beam: int = 20,
    max_prefix: int = 32,
    prob_threshold: float = 0.05,
) -> Dict[str, torch.Tensor]:
    """probs: (B, T, V) softmax posteriors; lengths: (B,), on one device.

    tokenset_mask: optional (V,) bool of the tokens the keywords allow
    (blank included).  Returns tensors sorted best-first: prefixes
    (B, W, U), plen (B, W), score (B, W) = pb + pnb, node_frame and
    node_prob (B, W, U), valid (B, W)."""
    b, t_max, _ = probs.shape
    w = path_beam
    dev = probs.device
    lengths = torch.as_tensor(lengths, device=dev)
    if tokenset_mask is not None:
        tokenset_mask = torch.as_tensor(tokenset_mask, dtype=torch.bool,
                                        device=dev)
    state = _init_state(b, w, max_prefix, dev)
    for t in range(t_max):
        state = beam_step(
            state, probs[:, t, :],
            torch.full((b,), t, dtype=torch.int64, device=dev),
            t < lengths, tokenset_mask, score_beam=score_beam,
            prob_threshold=prob_threshold)
    score = state.pb + state.pnb
    order = torch.argsort(-score, dim=1, stable=True)

    def g(arr):
        idx = order.reshape(b, w, *([1] * (arr.dim() - 2)))
        return torch.gather(arr, 1, idx.expand_as(arr))

    return {
        "prefixes": g(state.prefixes),
        "plen": g(state.plen),
        "score": g(score),
        "node_frame": g(state.node_frame),
        "node_prob": g(state.node_prob),
        "valid": g(state.valid),
    }


def beam_step(
    state: BeamState,
    p_t: torch.Tensor,
    frame_idx: torch.Tensor,
    live: torch.Tensor,
    tokenset_mask: Optional[torch.Tensor] = None,
    *,
    score_beam: int = 3,
    prob_threshold: float = 0.05,
) -> BeamState:
    """One frame-synchronous prefix-beam update.

    p_t: (B, V) softmax posteriors of this frame; frame_idx: (B,) int64
    absolute frame index stamped into node tracks; tokenset_mask: (V,)
    bool on p_t's device, or None; live: (B,) bool, rows
    with live False (or whose filter keeps nothing) keep their state
    unchanged.  Rows come out sorted best-first by pb + pnb."""
    b, w, u = state.prefixes.shape
    k = score_beam
    dev = p_t.device
    t = frame_idx.reshape(b, 1, 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    topv, topi = _top_k(p_t, k)  # (B, K)
    keep = topv > prob_threshold
    if tokenset_mask is not None:
        keep = keep & tokenset_mask[topi]
    any_kept = keep.any(dim=1)
    blank_in = ((topi == 0) & keep).any(dim=1)
    p_blank = p_t[:, 0]

    lidx = (state.plen - 1).clamp(min=0)
    last = torch.where(
        state.plen > 0,
        torch.gather(state.prefixes, 2, lidx[..., None])[..., 0],
        torch.full((), -1, dtype=torch.int64, device=dev))
    last0 = last.clamp(min=0)
    p_last = torch.gather(p_t, 1, last0)
    # the last token passes the filter this frame
    last_kept = ((topi[:, None, :] == last0[..., None])
                 & keep[:, None, :]).any(dim=2) & (last >= 0)
    total = state.pb + state.pnb

    # candidate 0 of each beam: stay (blank, or a repeat collapsing)
    stay_pb = torch.where(blank_in[:, None], total * p_blank[:, None], zero)
    stay_pnb = torch.where(last_kept, state.pnb * p_last, zero)
    old_np = torch.gather(state.node_prob, 2, lidx[..., None])[..., 0]
    upd = last_kept & (p_last > old_np) & (state.pnb > 1e-6)
    pos = torch.arange(u, device=dev)
    at_last = upd[..., None] & (pos[None, None, :] == lidx[..., None])
    stay_node_prob = torch.where(at_last, p_last[..., None],
                                 state.node_prob)
    stay_node_frame = torch.where(at_last, t, state.node_frame)
    stay_valid = state.valid & (stay_pb + stay_pnb > 0)

    # candidates 1..K of each beam: extend with top-k token s
    s_tok = topi[:, None, :]  # (B, 1, K)
    s_prob = topv[:, None, :]
    s_ok = keep[:, None, :] & (s_tok != 0)
    is_rep = s_tok == last[..., None]  # (B, W, K)
    ext_pnb = torch.where(is_rep, state.pb[..., None] * s_prob,
                          total[..., None] * s_prob)
    can_ext = (s_ok & state.valid[..., None]
               & (state.plen[..., None] < u) & (ext_pnb > 0))
    at_end = pos[None, None, None, :] == state.plen[..., None, None]
    ext_prefixes = torch.where(at_end, s_tok[..., None],
                               state.prefixes[:, :, None, :])
    ext_node_tok = torch.where(at_end, s_tok[..., None],
                               state.node_tok[:, :, None, :])
    ext_node_frame = torch.where(at_end, t[..., None],
                                 state.node_frame[:, :, None, :]
                                 ).expand(b, w, k, u)
    ext_node_prob = torch.where(at_end, s_prob[..., None],
                                state.node_prob[:, :, None, :])
    ext_plen = (state.plen[..., None] + 1).expand(b, w, k)

    # flatten the candidates: stay (W) then extend (W * K)
    n_cand = w * (k + 1)

    def flat(stay, ext):
        return torch.cat([stay, ext.reshape(b, w * k, *ext.shape[3:])],
                         dim=1)

    c_prefix = flat(state.prefixes, ext_prefixes)
    c_plen = flat(state.plen, ext_plen)
    c_ntok = flat(state.node_tok, ext_node_tok)
    c_nframe = flat(stay_node_frame, ext_node_frame)
    c_nprob = flat(stay_node_prob, ext_node_prob)
    c_valid = flat(stay_valid, can_ext)
    # invalid candidates carry no mass
    c_pb = torch.where(c_valid, flat(stay_pb, torch.zeros_like(ext_pnb)),
                       zero)
    c_pnb = torch.where(c_valid, flat(stay_pnb, ext_pnb), zero)

    # merge identical prefixes: hash sort + segment sums; the hash is
    # carried in the state, one multiply-add per extension
    ext_hash = _wrap_int32(state.phash[..., None] * _HASH_MULT
                           + (s_tok.expand(b, w, k) + 2))
    c_hash = flat(state.phash, ext_hash)
    cand = torch.arange(n_cand, device=dev)
    h = torch.where(c_valid, c_hash, _INT32_MIN + cand[None, :])
    order = torch.argsort(h, dim=1, stable=True)
    hs = torch.gather(h, 1, order)
    pbs = torch.gather(c_pb, 1, order)
    pnbs = torch.gather(c_pnb, 1, order)
    new_seg = torch.ones((b, n_cand), dtype=torch.int64, device=dev)
    new_seg[:, 1:] = (hs[:, 1:] != hs[:, :-1]).to(torch.int64)
    seg_id = torch.cumsum(new_seg, dim=1) - 1
    pb_sum = torch.zeros((b, n_cand), dtype=torch.float32,
                         device=dev).scatter_add_(1, seg_id, pbs)
    pnb_sum = torch.zeros((b, n_cand), dtype=torch.float32,
                          device=dev).scatter_add_(1, seg_id, pnbs)
    # each segment's representative: its max-pnb member (its node track
    # wins), ties to the lowest sorted index
    segmax = torch.full((b, n_cand), -float("inf"), dtype=torch.float32,
                        device=dev).scatter_reduce_(1, seg_id, pnbs, "amax")
    best_here = pnbs >= torch.gather(segmax, 1, seg_id) - 1e-12
    rep = torch.full((b, n_cand), n_cand, dtype=torch.int64,
                     device=dev).scatter_reduce_(
        1, seg_id, torch.where(best_here, cand[None, :], n_cand), "amin")
    rep = rep.clamp(max=n_cand - 1)
    seg_count = seg_id[:, -1] + 1
    seg_valid = cand[None, :] < seg_count[:, None]
    score = torch.where(seg_valid, pb_sum + pnb_sum,
                        torch.full((), -1.0, device=dev))

    # the top-W segments by score
    top_score, top_seg = _top_k(score, w)
    orig = torch.gather(order, 1, torch.gather(rep, 1, top_seg))

    def gather(arr):
        idx = orig.reshape(b, w, *([1] * (arr.dim() - 2)))
        return torch.gather(arr, 1, idx.expand(b, w, *arr.shape[2:]))

    new_state = BeamState(
        prefixes=gather(c_prefix),
        plen=gather(c_plen),
        pb=torch.gather(pb_sum, 1, top_seg),
        pnb=torch.gather(pnb_sum, 1, top_seg),
        node_tok=gather(c_ntok),
        node_frame=gather(c_nframe),
        node_prob=gather(c_nprob),
        valid=top_score > 0,
        phash=gather(c_hash),
    )
    # dead rows and frames whose filter kept nothing: unchanged
    frame_live = live & any_kept

    def sel(new, old):
        return torch.where(frame_live.reshape(b, *([1] * (new.dim() - 1))),
                           new, old)

    return BeamState(*(sel(n, o) for n, o in zip(new_state, state)))


def hyps_from_arrays(result: Dict[str, np.ndarray], i: int):
    """Utterance i's arrays (numpy, as ``{k: v.cpu().numpy()}`` of the
    search's result) -> host hypothesis tuples [(prefix, score, nodes)],
    the host decoder's format."""
    out = []
    plen = result["plen"][i]
    for wi in range(len(plen)):
        if not bool(result["valid"][i][wi]):
            continue
        n = int(plen[wi])
        prefix = tuple(int(x) for x in result["prefixes"][i][wi][:n])
        nodes = [
            dict(
                token=int(result["prefixes"][i][wi][j]),
                frame=int(result["node_frame"][i][wi][j]),
                prob=float(result["node_prob"][i][wi][j]),
            )
            for j in range(n)
        ]
        out.append((prefix, float(result["score"][i][wi]), nodes))
    return out
