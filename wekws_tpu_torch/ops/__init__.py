"""Fused serving kernels (CUDA, with plain PyTorch versions)."""

from wekws_tpu_torch.ops.fused_mdtc import (
    extract_mdtc_weights,
    fused_mdtc_forward,
    fused_mdtc_stream,
    init_stream_cache,
)

__all__ = [
    "extract_mdtc_weights",
    "fused_mdtc_forward",
    "fused_mdtc_stream",
    "init_stream_cache",
]
