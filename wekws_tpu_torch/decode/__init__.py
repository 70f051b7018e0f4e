"""CTC decoding: the host prefix beam search, the batched one on the
device, greedy decode and the accuracy measures of cv."""

from wekws_tpu_torch.decode.accuracy import acc_utterance
from wekws_tpu_torch.decode.batched_ctc import (
    batched_ctc_prefix_beam_search,
    hyps_from_arrays,
)
from wekws_tpu_torch.decode.calculator import Calculator
from wekws_tpu_torch.decode.ctc_prefix_beam_search import (
    PrefixBeam,
    ctc_prefix_beam_search,
    is_sublist,
)
from wekws_tpu_torch.decode.greedy import (
    batched_edit_distance,
    ctc_greedy_decode,
    ctc_token_accuracy,
)

__all__ = [
    "Calculator",
    "PrefixBeam",
    "acc_utterance",
    "batched_ctc_prefix_beam_search",
    "batched_edit_distance",
    "ctc_greedy_decode",
    "ctc_prefix_beam_search",
    "ctc_token_accuracy",
    "hyps_from_arrays",
    "is_sublist",
]
