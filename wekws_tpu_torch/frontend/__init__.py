"""Feature frontend: numpy Kaldi fbank/MFCC, CMVN loaders, config, and
the batched device ``FeatureExtractor``."""

from wekws_tpu_torch.frontend.cmvn import load_cmvn
from wekws_tpu_torch.frontend.features import (
    FeatureExtractor,
    frontend_from_dataset_conf,
)
from wekws_tpu_torch.frontend.kaldi import (
    FrontendConfig,
    compute_fbank_np,
    compute_mfcc_np,
)

__all__ = [
    "FeatureExtractor",
    "FrontendConfig",
    "compute_fbank_np",
    "compute_mfcc_np",
    "frontend_from_dataset_conf",
    "load_cmvn",
]
