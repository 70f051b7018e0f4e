"""CTC decoding on the host."""

from wekws_tpu_torch.decode.ctc_prefix_beam_search import (
    PrefixBeam,
    ctc_prefix_beam_search,
    is_sublist,
)

__all__ = ["PrefixBeam", "ctc_prefix_beam_search", "is_sublist"]
