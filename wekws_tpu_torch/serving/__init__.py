"""The serving daemon: one batched engine behind a framed-TCP protocol."""

from wekws_tpu_torch.serving.client import KwsClient
from wekws_tpu_torch.serving.server import KwsServer

__all__ = ["KwsClient", "KwsServer"]
