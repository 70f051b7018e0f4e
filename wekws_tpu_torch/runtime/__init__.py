"""Streaming frontend and serving engines."""

from wekws_tpu_torch.runtime.batch_spotter import BatchMaxPoolSpotter
from wekws_tpu_torch.runtime.keyword_spotter import (
    KeyWordSpotter,
    StreamDetector,
)
from wekws_tpu_torch.runtime.streaming_frontend import StreamingFrontend

__all__ = ["BatchMaxPoolSpotter", "KeyWordSpotter", "StreamDetector",
           "StreamingFrontend"]
