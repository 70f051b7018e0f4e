"""CTC keyword scoring: decode -> keyword match -> confidence.

Port of wekws_tpu/eval/score_ctc.py (the reference wekws's
bin/score_ctc.py): softmax posteriors are decoded by the token-set
pruned prefix beam search, the first (best) hypothesis that holds a
keyword's tokens as a contiguous run is the hit, and its score is the
square root of the product of the matched tokens' probabilities, as the
reference computes it.
"""

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wekws_tpu_torch.decode.batched_ctc import (
    batched_ctc_prefix_beam_search,
    hyps_from_arrays,
)
from wekws_tpu_torch.decode.ctc_prefix_beam_search import (
    ctc_prefix_beam_search,
    is_sublist,
)


def build_keywords_token(
    keywords: Sequence[str], tokenizer
) -> Tuple[Dict[str, dict], set]:
    """keyword -> {'token_id': tuple, 'token_str': str}, and the union of
    their token ids with blank 0, the decode's pruning set."""
    keywords_token = {}
    idxset = {0}
    for kw in keywords:
        _, ids = tokenizer.tokenize(" ".join(list(kw)))
        keywords_token[kw] = {
            "token_id": tuple(ids),
            "token_str": " ".join(str(i) for i in ids),
        }
        idxset.update(ids)
    return keywords_token, idxset


def detect_keyword(
    hyps: List[tuple],
    keywords_token: Dict[str, dict],
) -> Optional[Tuple[str, float, int, int]]:
    """-> (keyword, score, start_frame, end_frame) or None."""
    for prefix_ids, _path_score, nodes in hyps:
        if len(prefix_ids) != len(nodes):
            raise ValueError("a hypothesis needs one node per token")
        for word, info in keywords_token.items():
            lab = list(info["token_id"])
            offset = is_sublist(list(prefix_ids), lab)
            if offset != -1 and lab:
                hit_score = 1.0
                for idx in range(offset, offset + len(lab)):
                    hit_score *= nodes[idx]["prob"]
                start = nodes[offset]["frame"]
                end = nodes[offset + len(lab) - 1]["frame"]
                return word, math.sqrt(hit_score), start, end
    return None


def write_ctc_score_file(
    forward_fn: Callable[[Dict], tuple],
    dataset: Iterable[Dict],
    keywords_token: Dict[str, dict],
    keywords_idxset: set,
    score_file: str,
    score_beam_size: int = 3,
    path_beam_size: int = 20,
    device_decode: bool = False,
    device: Optional[torch.device] = None,
) -> int:
    """forward_fn: batch -> (softmax posteriors (B, T, V), lengths) as
    numpy arrays.

    Writes ``key detected <keyword> <score>`` / ``key rejected`` lines
    (the compute_det_ctc input) and skips fill rows (``valid`` 0).
    ``device_decode`` decodes each batch at once with the batched prefix
    beam search on ``device`` (decode/batched_ctc.py) instead of the host
    decoder per utterance.  Returns the number of utterances scored."""
    n = 0
    with open(score_file, "w", encoding="utf8") as fout:
        for batch in dataset:
            probs, lengths = forward_fn(batch)
            probs = np.asarray(probs)
            lengths = np.asarray(lengths)
            if device_decode:
                v = probs.shape[-1]
                mask = np.zeros(v, bool)
                mask[sorted(i for i in keywords_idxset if i < v)] = True
                result = batched_ctc_prefix_beam_search(
                    torch.as_tensor(probs, device=device),
                    torch.as_tensor(lengths, device=device),
                    tokenset_mask=torch.as_tensor(mask, device=device),
                    score_beam=score_beam_size, path_beam=path_beam_size,
                )
                result = {k: val.cpu().numpy() for k, val in result.items()}
            valid = np.asarray(
                batch.get("valid", np.ones(len(batch["keys"])))
            )
            for i, key in enumerate(batch["keys"]):
                if i < len(valid) and valid[i] == 0:
                    continue  # bucketed fill row: holds no utterance
                if device_decode:
                    hyps = hyps_from_arrays(result, i)
                else:
                    hyps = ctc_prefix_beam_search(
                        probs[i], int(lengths[i]), keywords_idxset,
                        score_beam_size, path_beam_size,
                    )
                hit = detect_keyword(hyps, keywords_token)
                if hit is not None:
                    word, score, _, _ = hit
                    fout.write(f"{key} detected {word} {score:.3f}\n")
                else:
                    fout.write(f"{key} rejected\n")
                n += 1
    return n


def read_ctc_score_file(path: str) -> Dict[str, tuple]:
    """{key: (decision, keyword, score)} of a file ``write_ctc_score_file``
    wrote; keyword and score are None on a rejected line."""
    table = {}
    with open(path, encoding="utf8") as f:
        for line in f:
            arr = line.split()
            table[arr[0]] = ((arr[1], arr[2], float(arr[3]))
                             if arr[1] == "detected" else (arr[1], None, None))
    return table


def compare_ctc_score_files(got_path: str,
                            want_path: str) -> Tuple[List[str], float]:
    """(keys whose decision or keyword differ, largest score difference
    over the utterances detected in both) of two CTC score files of the
    same keys."""
    got, want = read_ctc_score_file(got_path), read_ctc_score_file(want_path)
    if got.keys() != want.keys():
        raise ValueError(f"{got_path} and {want_path} hold other keys")
    flips = [k for k in got if got[k][:2] != want[k][:2]]
    errs = [abs(got[k][2] - want[k][2]) for k in got
            if k not in flips and got[k][0] == "detected"]
    return flips, max(errs, default=0.0)
