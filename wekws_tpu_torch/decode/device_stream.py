"""On-device streaming keyword detection: beam + FSM on the card.

Port of wekws_tpu/decode/device_stream.py.  The host engine
(runtime/keyword_spotter.py ``StreamDetector``) advances a Python
prefix beam and a detection finite-state machine per frame and per
stream.  Here the whole per-frame loop (prefix beam update, keyword
sublist match, geometric score, threshold / duration / refractory
gates, beam reset on activation, stale-keyword reset) runs as batched
tensor operations over every stream, so the serving engine reads back
one small event tensor a step instead of running N Python beams.  The
frames of a chunk are a Python loop (``lax.scan`` in the JAX package):
no operation in it reads a value back to the host.

Semantics replicate ``StreamDetector``, including the reference's
quirks it inherits:

* ``hit_score`` is a PERSISTENT accumulator: every frame whose beam
  contains a keyword multiplies the span's node probabilities in and
  takes a sqrt; it only resets with the beam (activation, stale reset,
  stream reset).
* Matching order is: best-scoring hypothesis first, keywords in table
  order, first (leftmost) occurrence in the prefix; the first match
  wins.
* Activation resets the beam and skips the remaining frames of the
  chunk; the model cache is NOT reset.
* After each chunk, if the best hypothesis' first token is older than
  ``max_frames``, the beam resets (stale keyword).

Frame indices are absolute (pre-frame-skip numbering): frame i of a
chunk is ``t0 + i * downsampling``.

Known deviations from the host engine, the JAX package's own: on prefix
merges the batched beam keeps the max-pnb contributor's node track
where the host keeps the first-created one (decode/batched_ctc.py), so
the accumulated ``hit_score`` of a keyword spelled in a merged noise
hypothesis can drift between the two engines; and the batched beam
lacks the host decoder's 1e-6 gates on its repeat paths (ROADMAP C.4).
Decisions, keyword identity and timestamps match the JAX function.
"""

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from wekws_tpu_torch.decode.batched_ctc import (
    BeamState,
    _init_state,
    beam_step,
)


class StreamDecodeState(NamedTuple):
    beam: BeamState
    hit_score: torch.Tensor        # (B,) f32, persistent accumulator
    last_active_pos: torch.Tensor  # (B,) int64, -1 = never activated


def init_stream_state(b: int, path_beam: int = 20, max_prefix: int = 32,
                      device="cpu") -> StreamDecodeState:
    return StreamDecodeState(
        beam=_init_state(b, path_beam, max_prefix, device),
        hit_score=torch.ones((b,), dtype=torch.float32, device=device),
        last_active_pos=torch.full((b,), -1, dtype=torch.int64,
                                   device=device),
    )


def make_keyword_arrays(
    keywords_token: Dict[str, dict], vocab: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
    """Keyword table (as build_keyword_tables builds it) -> arrays.

    Returns (kw_tok (KW, L) int32 -1-padded, kw_len (KW,) int32,
    tokenset_mask (V,) bool incl. blank, kw_names list) with KW rows in
    table order, the match-priority order of the host FSM.
    """
    names = list(keywords_token.keys())
    ids = [list(keywords_token[n]["token_id"]) for n in names]
    max_len = max((len(i) for i in ids), default=1) or 1
    kw_tok = np.full((len(names), max_len), -1, np.int32)
    kw_len = np.zeros((len(names),), np.int32)
    mask = np.zeros((vocab,), bool)
    mask[0] = True  # blank always passes the filter
    for r, seq in enumerate(ids):
        kw_tok[r, :len(seq)] = seq
        kw_len[r] = len(seq)
        mask[seq] = True
    return kw_tok, kw_len, mask, names


def _match_keywords(beam: BeamState, kw_tok: torch.Tensor,
                    kw_len: torch.Tensor):
    """First (hyp, keyword, offset) sublist match per batch row.

    Returns matched (B,), kw index (B,), start/end abs frames (B,),
    span probability product (B,).  Priority is lexicographic over
    (hypothesis rank, keyword row, offset): the host FSM's order.
    """
    b, w, u = beam.prefixes.shape
    kw, lmax = kw_tok.shape
    dev = beam.prefixes.device

    off = torch.arange(u, device=dev)
    ok = torch.ones((b, w, kw, u), dtype=torch.bool, device=dev)
    for j in range(lmax):
        idx = (off + j).clamp(max=u - 1)          # (U,)
        pj = beam.prefixes[:, :, idx]              # (B, W, U)
        past = (j >= kw_len)[None, None, :, None]
        eq = pj[:, :, None, :] == kw_tok[None, None, :, j, None]
        ok = ok & (eq | past)
    fits = (off[None, None, None, :] + kw_len[None, None, :, None]
            <= beam.plen[:, :, None, None])
    match = (ok & fits & beam.valid[:, :, None, None]
             & (kw_len > 0)[None, None, :, None])

    n = w * kw * u
    flat = match.reshape(b, n)
    pri = torch.arange(n, device=dev)
    sel = torch.where(flat, pri[None, :], n).amin(dim=1)  # (B,)
    matched = sel < n
    sel = sel.clamp(max=n - 1)
    wsel = sel // (kw * u)
    rem = sel % (kw * u)
    kwsel = rem // u
    osel = rem % u

    def row(arr):  # (B, W, U) -> (B, U) at hypothesis wsel
        return torch.gather(arr, 1,
                            wsel[:, None, None].expand(b, 1, u))[:, 0, :]

    nframe = row(beam.node_frame)
    nprob = row(beam.node_prob)
    mlen = kw_len[kwsel]  # (B,)

    def at(arr, pos):  # (B, U), (B,) -> (B,)
        return torch.gather(arr, 1, pos.clamp(max=u - 1)[:, None])[:, 0]

    start = at(nframe, osel)
    end = at(nframe, osel + (mlen - 1).clamp(min=0))
    prod = torch.ones((b,), dtype=torch.float32, device=dev)
    for j in range(lmax):
        prod = prod * torch.where(j < mlen, at(nprob, osel + j), 1.0)
    return matched, kwsel, start, end, prod


def _sel_rows(mask: torch.Tensor, new, old):
    """Row-wise select over matching tuples of (B, ...) tensors."""
    return type(old)(*(
        torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
        for n, o in zip(new, old)))


def stream_detect_step(
    state: StreamDecodeState,
    probs: torch.Tensor,
    active: torch.Tensor,
    reset: torch.Tensor,
    t0: torch.Tensor,
    kw_tok: torch.Tensor,
    kw_len: torch.Tensor,
    tokenset_mask: torch.Tensor,
    lengths: torch.Tensor = None,
    *,
    threshold: float,
    min_frames: int,
    max_frames: int,
    interval_frames: int,
    downsampling: int = 1,
    score_beam: int = 3,
    prob_threshold: float = 0.05,
):
    """Advance every stream's beam+FSM over one chunk of posteriors.

    All tensors on one device.  probs: (B, T, V) softmaxed; active:
    (B,) bool, rows that hold new frames (others stay bit-identical);
    reset: (B,) bool, a full per-row state reset applied first (a new
    client in the slot); t0: (B,) int64 absolute frame index of the
    chunk's first frame; kw_tok (KW, L), kw_len (KW,) int64 and
    tokenset_mask (V,) bool from ``make_keyword_arrays``; lengths:
    optional (B,) int64 valid-frame count per row (frames at positions
    >= lengths[b] are zero padding, a flushed tail, and leave row b
    untouched; None = every row carries T frames).

    Returns (new_state, events) where events holds (B,) tensors: fired
    (bool), kw (int64 row of the keyword table), start/end (int64
    absolute frames), score (f32), at most one activation per row per
    chunk (the FSM skips the rest of the chunk, as the host does).
    """
    b, t_len, _v = probs.shape
    w = state.beam.pb.shape[1]
    u = state.beam.prefixes.shape[2]
    dev = probs.device

    fresh = init_stream_state(b, w, u, dev)
    state = StreamDecodeState(
        beam=_sel_rows(reset, fresh.beam, state.beam),
        hit_score=torch.where(reset, 1.0, state.hit_score),
        last_active_pos=torch.where(reset, -1, state.last_active_pos),
    )
    i64 = dict(dtype=torch.int64, device=dev)
    fired = torch.zeros((b,), dtype=torch.bool, device=dev)
    ev_kw = torch.zeros((b,), **i64)
    ev_start = torch.zeros((b,), **i64)
    ev_end = torch.zeros((b,), **i64)
    ev_score = torch.zeros((b,), dtype=torch.float32, device=dev)
    if lengths is None:
        lengths = torch.full((b,), t_len, **i64)

    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    st = state
    for i in range(t_len):
        abs_t = t0 + i * downsampling
        live = active & ~done & (i < lengths)
        beam = beam_step(st.beam, probs[:, i], abs_t, live, tokenset_mask,
                         score_beam=score_beam,
                         prob_threshold=prob_threshold)
        matched, kwsel, m_start, m_end, m_prod = _match_keywords(
            beam, kw_tok, kw_len)
        matched = matched & live
        hs = torch.where(matched, torch.sqrt(st.hit_score * m_prod),
                         st.hit_score)
        dur = m_end - m_start
        fire = (matched & (hs >= threshold) & (dur >= min_frames)
                & (dur <= max_frames)
                & ((st.last_active_pos == -1)
                   | (m_end - st.last_active_pos >= interval_frames)))
        st = StreamDecodeState(
            beam=_sel_rows(fire, fresh.beam, beam),
            hit_score=torch.where(live, torch.where(fire, 1.0, hs),
                                  st.hit_score),
            last_active_pos=torch.where(fire, m_end, st.last_active_pos),
        )
        fired = fired | fire
        ev_kw = torch.where(fire, kwsel, ev_kw)
        ev_start = torch.where(fire, m_start, ev_start)
        ev_end = torch.where(fire, m_end, ev_end)
        ev_score = torch.where(fire, hs, ev_score)
        done = done | fire

    # stale-keyword reset at chunk end (host: process() tail)
    total = t0 + lengths * downsampling
    kw_start = st.beam.node_frame[:, 0, 0]
    stale = (active & (st.beam.plen[:, 0] > 0)
             & ((total - kw_start) > max_frames))
    state = StreamDecodeState(
        beam=_sel_rows(stale, fresh.beam, st.beam),
        hit_score=torch.where(stale, 1.0, st.hit_score),
        last_active_pos=st.last_active_pos,
    )
    events = {"fired": fired, "kw": ev_kw, "start": ev_start,
              "end": ev_end, "score": ev_score}
    return state, events
