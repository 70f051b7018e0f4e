"""Streaming frontends and serving engines."""

from wekws_tpu_torch.runtime.batch_spotter import (
    BatchKeywordSpotter,
    BatchMaxPoolSpotter,
)
from wekws_tpu_torch.runtime.keyword_spotter import (
    KeyWordSpotter,
    StreamDetector,
)
from wekws_tpu_torch.runtime.streaming_frontend import StreamingFrontend

__all__ = ["BatchKeywordSpotter", "BatchMaxPoolSpotter", "KeyWordSpotter",
           "StreamDetector", "StreamingFrontend"]
