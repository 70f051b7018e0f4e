"""Streaming KWS models.  Chunked forward with the cache
equals the whole-utterance forward."""

from wekws_tpu_torch.models.kws_model import KWSModel, init_model, mask_padding
from wekws_tpu_torch.models.fsmn import FSMN
from wekws_tpu_torch.models.gru import GRU
from wekws_tpu_torch.models.mdtc import MDTC
from wekws_tpu_torch.models.tcn import TCN

__all__ = ["FSMN", "GRU", "KWSModel", "MDTC", "TCN", "init_model",
           "mask_padding"]
