"""Fused fbank / MFCC frontend: CUDA kernel and its plain version.

The JAX package offers its feature chain as one Pallas program
(wekws_tpu/ops/fused_frontend.py, opt-in through ``dataset_conf:
fused_frontend: true``); here the same function is the hand-written
Hopper kernel ``csrc/fused_frontend.cu``, launched through ``ctypes``:
wave -> frames -> optional N(0, 1) * dither per frame sample -> folded
DFT (``analysis``: DC removal, preemphasis, window and DFT in one
``(frame_length, 2 * nbin)`` matrix, columns ``[re | im]``) -> power
(or magnitude) -> mel -> ``log(max(., eps))`` -> optional DCT.  The
kernel cuts the overlapping frames from the ``(B, S)`` wave itself, so
neither the frames buffer nor the noise, the spectrum or the power
ever exist in device memory.

``fused_fbank`` takes the plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  It counts its
kernel launches in ``fused_fbank.launches``.  A wave shorter than one
frame gives the empty ``(B, 0, D)`` features without a launch.  Unlike
the JAX function it never returns None: an odd ``frame_length`` with
dither and any operator size that fits a block's shared memory run.

Dither.  The kernel draws its noise from a counter-based generator
(Philox4x32-10, Box-Muller) keyed by ``seed``, a one-element int64
tensor on the waves' device, which the kernel reads itself: the host
never waits for its value.  The noise of a sample depends on the seed
and on its (utterance, frame, sample) position in the call, not on the
launch grid: the same seed gives the same bits, and one call on a batch
does NOT equal two calls on its halves (the second half would repeat
the first half's noise).  The plain version draws ``torch.randn`` from a
generator seeded with the same number, or takes ``noise``: the two
agree in distribution, not in bits.
"""

import ctypes
from typing import Optional

import torch

from wekws_tpu_torch.ops import cuda_build
from wekws_tpu_torch.ops.fused_common import check_tensor


def _num_frames(s: int, frame_length: int, frame_shift: int) -> int:
    return 1 + (s - frame_length) // frame_shift if s >= frame_length else 0


def fused_fbank_plain(
    waves: torch.Tensor,
    analysis: torch.Tensor,
    mel_t: torch.Tensor,
    dct_t: Optional[torch.Tensor],
    *,
    frame_length: int,
    frame_shift: int,
    dither: float = 0.0,
    seed: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    use_power: bool = True,
    use_log: bool = True,
    epsilon: float = 1.1921e-07,
) -> torch.Tensor:
    """Eager PyTorch version of the kernel.  With ``dither > 0`` the
    ``(B, T, frame_length)`` noise is ``noise`` when given (so a test
    can feed two implementations the same numbers), else ``torch.randn``
    from a generator seeded with ``seed``."""
    b, s = waves.shape
    t = _num_frames(s, frame_length, frame_shift)
    nbin = analysis.shape[1] // 2
    out_dim = mel_t.shape[1] if dct_t is None else dct_t.shape[1]
    if t == 0:
        return waves.new_zeros((b, 0, out_dim))
    frames = waves.unfold(1, frame_length, frame_shift)
    if dither > 0.0:
        if noise is None:
            gen = torch.Generator(device=waves.device)
            gen.manual_seed(int(seed.item()) if seed is not None else 0)
            noise = torch.randn(frames.shape, generator=gen,
                                device=waves.device)
        frames = frames + dither * noise
    spec = torch.matmul(frames, analysis)
    power = spec[..., :nbin] ** 2 + spec[..., nbin:] ** 2
    if not use_power:
        power = torch.sqrt(power)
    mel = torch.matmul(power, mel_t)
    if use_log:
        mel = torch.log(torch.clamp(mel, min=epsilon))
    if dct_t is not None:
        mel = torch.matmul(mel, dct_t)
    return mel


def _kernel_fn():
    lib = cuda_build.load("fused_frontend")
    fn = lib.fused_fbank_launch
    if fn.argtypes is None:  # without argtypes ctypes cuts pointers to int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_fbank_error_string.argtypes = [ctypes.c_int]
        lib.fused_fbank_error_string.restype = ctypes.c_char_p
    return lib, fn


def fused_fbank(
    waves: torch.Tensor,
    analysis: torch.Tensor,
    mel_t: torch.Tensor,
    dct_t: Optional[torch.Tensor],
    *,
    frame_length: int,
    frame_shift: int,
    dither: float = 0.0,
    seed: Optional[torch.Tensor] = None,
    use_power: bool = True,
    use_log: bool = True,
    epsilon: float = 1.1921e-07,
) -> torch.Tensor:
    """(B, S) float32 waves -> (B, T, D) features.

    ``analysis`` is the folded ``(frame_length, 2 * nbin)`` re|im DFT
    operator, ``mel_t`` the ``(nbin, M)`` mel bank, ``dct_t`` the
    optional ``(M, C)`` DCT for MFCC; all float32 and contiguous on the
    waves' device.  ``seed`` (one int64 element on that device) is read
    only when ``dither > 0``."""
    if waves.dim() != 2:
        raise ValueError(f"waves must be (B, S), got {tuple(waves.shape)}")
    b, s = waves.shape
    dev = waves.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if frame_length < 1 or frame_shift < 1 or b < 1:
        raise ValueError("empty batch, frame or shift")
    if analysis.dim() != 2 or analysis.shape[1] % 2:
        raise ValueError("analysis must be (frame_length, 2 * nbin)")
    nbin = analysis.shape[1] // 2
    n_mel = mel_t.shape[-1]
    check_tensor("waves", waves, (b, s), dev)
    check_tensor("analysis", analysis, (frame_length, 2 * nbin), dev)
    check_tensor("mel_t", mel_t, (nbin, n_mel), dev)
    out_dim = n_mel
    if dct_t is not None:
        out_dim = dct_t.shape[-1]
        check_tensor("dct_t", dct_t, (n_mel, out_dim), dev)
    dither = float(dither)
    if dither > 0.0:
        if seed is None:
            raise ValueError("dither > 0 needs a seed tensor")
        check_tensor("seed", seed, (1,), dev, torch.int64)
    t = _num_frames(s, frame_length, frame_shift)
    if t == 0:  # nothing to compute
        return waves.new_zeros((b, 0, out_dim))
    if dev.type == "cpu":
        return fused_fbank_plain(
            waves, analysis, mel_t, dct_t, frame_length=frame_length,
            frame_shift=frame_shift, dither=dither, seed=seed,
            use_power=use_power, use_log=use_log, epsilon=epsilon)
    lib, fn = _kernel_fn()
    out = torch.empty((b, t, out_dim), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(waves.data_ptr(), analysis.data_ptr(), mel_t.data_ptr(),
                 dct_t.data_ptr() if dct_t is not None else None,
                 seed.data_ptr() if dither > 0.0 else None, out.data_ptr(),
                 b, s, t, frame_length, frame_shift, nbin, n_mel, out_dim,
                 dither, int(bool(use_power)), int(bool(use_log)),
                 float(epsilon), stream)
    if err != 0:
        msg = lib.fused_fbank_error_string(err).decode()
        raise RuntimeError(f"fused_fbank kernel launch failed: {msg} ({err})")
    fused_fbank.launches += 1
    return out


fused_fbank.launches = 0
