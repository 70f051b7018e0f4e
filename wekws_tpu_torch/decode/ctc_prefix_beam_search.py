"""CTC prefix beam search with per-token timestamps.

The port's own numpy-only copy of
wekws_tpu/decode/ctc_prefix_beam_search.py: a host-side decoder over
posteriors computed on the device (the search is per utterance and
tiny).  Semantics match the reference wekws decoder:

* per-frame first prune: top ``score_beam_size`` tokens, kept only if
  prob > 0.05 and (optionally) inside the keyword token set;
* standard blank/non-blank prefix merging in probability space;
* every hypothesis carries a node list ``{token, frame, prob}`` so a
  detected keyword has per-token timestamps; a repeated emission
  updates the node to its best-scoring frame;
* second prune to ``path_beam_size`` by total probability.

Node-list bookkeeping replicates the reference exactly, including its
aliasing semantics: node lists are copied shallowly, so the
repeat-collapse branch's in-place ``nodes[-1]['prob'] = ps`` update
propagates into sibling hypotheses whose lists share that dict.
Deep-copying here looks cleaner but changes timestamps and score files
relative to the reference.

The incremental ``PrefixBeam`` class exposes the same recursion one
frame at a time for the streaming engine
(wekws_tpu_torch.runtime.keyword_spotter).
"""

from collections import defaultdict
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

Hypothesis = Tuple[Tuple[int, ...], float, List[dict]]


class PrefixBeam:
    """Incremental CTC prefix beam search state."""

    def __init__(
        self,
        keywords_tokenset: Optional[Set[int]] = None,
        score_beam_size: int = 3,
        path_beam_size: int = 20,
        prob_threshold: float = 0.05,
        blank_id: int = 0,
    ):
        self.tokenset = keywords_tokenset
        self.score_beam_size = score_beam_size
        self.path_beam_size = path_beam_size
        self.prob_threshold = prob_threshold
        self.blank_id = blank_id
        self.reset()

    def reset(self):
        # prefix -> (p_blank, p_nonblank, nodes)
        self.cur_hyps = [(tuple(), (1.0, 0.0, []))]
        self.abs_frame = 0  # absolute frame index across chunks

    def step(self, probs: np.ndarray) -> None:
        """Advance the beam by one frame of posteriors (V,)."""
        t = self.abs_frame
        self.abs_frame += 1

        # stable descending sort: ties keep the lower token index, the
        # order torch.topk produces in the reference
        order = np.argsort(-probs, kind="stable")[: self.score_beam_size]
        # note: blank is NOT special-cased — callers' token sets always
        # include it (text.tokenizer.keyword_token_set seeds {0}, as the
        # reference's set_keywords does), and the reference filter
        # requires membership
        filtered = [
            int(i)
            for i in order
            if probs[i] > self.prob_threshold
            and (self.tokenset is None or int(i) in self.tokenset)
        ]
        if not filtered:
            return

        next_hyps = defaultdict(lambda: (0.0, 0.0, []))
        for s in filtered:
            ps = float(probs[s])
            for prefix, (pb, pnb, nodes) in self.cur_hyps:
                last = prefix[-1] if prefix else None
                if s == self.blank_id:
                    n_pb, n_pnb, _ = next_hyps[prefix]
                    next_hyps[prefix] = (
                        n_pb + (pb + pnb) * ps, n_pnb, list(nodes),
                    )
                elif s == last:
                    if pnb > 1e-6:
                        # repeat collapses: *ss -> *s.  The shallow
                        # list copy + in-place dict update reproduce the
                        # reference (shared node dicts see the
                        # best-frame update across sibling hypotheses).
                        n_pb, n_pnb, _ = next_hyps[prefix]
                        new_nodes = list(nodes)
                        if ps > new_nodes[-1]["prob"]:
                            new_nodes[-1]["prob"] = ps
                            new_nodes[-1]["frame"] = t
                        next_hyps[prefix] = (n_pb, n_pnb + pnb * ps, new_nodes)
                    if pb > 1e-6:
                        # blank separates: *s-s -> *ss
                        n_prefix = prefix + (s,)
                        n_pb, n_pnb, _ = next_hyps[n_prefix]
                        new_nodes = list(nodes)
                        new_nodes.append(dict(token=s, frame=t, prob=ps))
                        next_hyps[n_prefix] = (n_pb, n_pnb + pb * ps, new_nodes)
                else:
                    n_prefix = prefix + (s,)
                    n_pb, n_pnb, prev_nodes = next_hyps[n_prefix]
                    if prev_nodes:
                        if ps > prev_nodes[-1]["prob"]:
                            # replace-last via pop/append on the entry's
                            # own list (the dict is replaced, not
                            # mutated, so other beams keep theirs)
                            new_nodes = prev_nodes
                            new_nodes.pop()
                            new_nodes.append(dict(token=s, frame=t, prob=ps))
                        else:
                            new_nodes = prev_nodes
                    else:
                        new_nodes = list(nodes)
                        new_nodes.append(dict(token=s, frame=t, prob=ps))
                    next_hyps[n_prefix] = (
                        n_pb, n_pnb + (pb + pnb) * ps, new_nodes,
                    )

        ordered = sorted(
            next_hyps.items(), key=lambda x: x[1][0] + x[1][1], reverse=True
        )
        self.cur_hyps = ordered[: self.path_beam_size]

    def hypotheses(self) -> List[Hypothesis]:
        """(prefix, total_prob, nodes) sorted best-first."""
        return [(p, pb + pnb, nodes) for p, (pb, pnb, nodes) in self.cur_hyps]


def ctc_prefix_beam_search(
    probs: np.ndarray,
    length: Optional[int] = None,
    keywords_tokenset: Optional[Set[int]] = None,
    score_beam_size: int = 3,
    path_beam_size: int = 20,
) -> List[Hypothesis]:
    """Offline decode of (T, V) frame posteriors (already softmaxed)."""
    beam = PrefixBeam(
        keywords_tokenset, score_beam_size, path_beam_size
    )
    t = probs.shape[0] if length is None else int(length)
    for i in range(t):
        beam.step(np.asarray(probs[i]))
    return beam.hypotheses()


def is_sublist(main: Sequence[int], check: Sequence[int]) -> int:
    """Offset of the first contiguous occurrence of ``check`` inside
    ``main``, or -1: the keyword-match rule of the reference scorer
    (whose range() misses a match ending exactly at the tail, which is
    included here)."""
    m, c = list(main), list(check)
    if len(m) < len(c):
        return -1
    for i in range(len(m) - len(c) + 1):
        if m[i : i + len(c)] == c:
            return i
    return -1
