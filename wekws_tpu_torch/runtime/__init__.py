"""Streaming frontend and serving engines."""

from wekws_tpu_torch.runtime.batch_spotter import BatchMaxPoolSpotter
from wekws_tpu_torch.runtime.streaming_frontend import StreamingFrontend

__all__ = ["BatchMaxPoolSpotter", "StreamingFrontend"]
