"""Helpers shared by the fused serving kernels.

Every fused temporal-conv backbone streams with the same
``(L, B, pad_max, C)`` left-context ring cache, and folds
inference-time BatchNorm into the preceding conv in float64.  Every
wrapper checks what it hands its kernel with ``check_tensor``.
"""

import torch


def check_tensor(name: str, t: torch.Tensor, shape, device,
                 dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``: what a kernel reading raw pointers relies on."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def init_ring_cache(
    n_layers: int, batch: int, pad_max: int, channels: int, device="cpu"
) -> torch.Tensor:
    """(L, B, pad_max, C) zero left context for a fresh stream."""
    return torch.zeros(
        (n_layers, batch, pad_max, channels), dtype=torch.float32,
        device=device,
    )


def fold_bn(w, b, gamma, beta, mean, var, eps: float = 1e-5):
    """Fold BN(gamma, beta, mean, var) into a conv/dense (w, b).

    ``w``'s last axis is the output-channel axis; ``b`` may be None.
    Folding is done in float64 on the CPU so the fused weights match
    apply-time BN to float32 ulp.  Returns float32 CPU tensors."""

    def f64(t):
        return torch.as_tensor(t).detach().to("cpu", torch.float64)

    scale = f64(gamma) / torch.sqrt(f64(var) + eps)
    w = f64(w) * scale
    b = f64(b) if b is not None else torch.zeros((), dtype=torch.float64)
    b = (b - f64(mean)) * scale + f64(beta)
    return w.to(torch.float32), b.to(torch.float32)
