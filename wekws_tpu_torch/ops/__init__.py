"""Fused kernels (CUDA, each with its plain PyTorch version)."""

from wekws_tpu_torch.ops.fused_frontend import fused_fbank
from wekws_tpu_torch.ops.fused_fsmn import (
    extract_fsmn_weights,
    fused_fsmn_forward,
    fused_fsmn_layers,
    init_fsmn_cache,
)
from wekws_tpu_torch.ops.fused_mdtc import (
    extract_mdtc_weights,
    fused_mdtc_forward,
    fused_mdtc_stream,
    init_stream_cache,
)
from wekws_tpu_torch.ops.fused_tcn import (
    extract_ds_tcn_weights,
    fused_ds_tcn,
    init_tcn_cache,
)

__all__ = [
    "extract_ds_tcn_weights",
    "extract_fsmn_weights",
    "extract_mdtc_weights",
    "fused_ds_tcn",
    "fused_fbank",
    "fused_fsmn_forward",
    "fused_fsmn_layers",
    "fused_mdtc_forward",
    "fused_mdtc_stream",
    "init_fsmn_cache",
    "init_stream_cache",
    "init_tcn_cache",
]
