"""Streaming KWS models (inference).  Chunked forward with the cache
equals the whole-utterance forward."""

from wekws_tpu_torch.models.kws_model import KWSModel, init_model, mask_padding
from wekws_tpu_torch.models.mdtc import MDTC

__all__ = ["KWSModel", "MDTC", "init_model", "mask_padding"]
