"""Fused fbank / MFCC frontend: CUDA kernel and its plain version.

The JAX package offers its feature chain as one Pallas program
(wekws_tpu/ops/fused_frontend.py, opt-in through ``dataset_conf:
fused_frontend: true``); here the same function is the hand-written
Hopper kernel ``csrc/fused_frontend.cu``, launched through ``ctypes``:
wave -> frames -> optional N(0, 1) * dither per frame sample -> DC
removal, preemphasis, window, real DFT -> power (or magnitude) -> mel
-> ``log(max(., eps))`` -> optional DCT.  The kernel cuts the
overlapping frames from the ``(B, S)`` wave itself, so neither the
frames buffer nor the noise, the spectrum or the power ever exist in
device memory.

Two plans, chosen from the configuration before the launch
(``fbank_plan``): a padded size ``n_fft`` that is a power of two from
128 to 2048 (every shipped recipe) runs the FFT plan: the pre-chain in
shared memory from its parts (``window``, ``preemphasis``,
``remove_dc_offset``), a real FFT of ``n_fft`` points with the
``twiddles`` table (``twiddle_table``, float64 rounded once), the
lowest ``LOW_BINS`` bins from the columns of the folded operator
instead (``low``, from ``low_operator``), mel over each filter's
nonzero bins (``bands``, from ``mel_bands``).  Any other
padded size (``round_to_power_of_two: false``) runs the dense plan: the
folded operator ``analysis`` (DC removal, preemphasis, window and DFT in
one ``(frame_length, 2 * nbin)`` matrix, columns ``[re | im]``), as the
TPU kernel does; so does a call given the folded operator alone (no
``n_fft``).

``fused_fbank`` takes the plain PyTorch version (``analysis`` and three
matmuls) only for tensors on the CPU; for CUDA tensors it launches a
kernel or raises.  It counts its kernel launches in
``fused_fbank.launches``.  A wave shorter than one frame gives the
empty ``(B, 0, D)`` features without a launch.  Unlike the JAX function
it never returns None: an odd ``frame_length`` with dither and any
operator size that fits a block's shared memory run.

Dither.  The kernel draws its noise from a counter-based generator
(Philox4x32-10, Box-Muller) keyed by ``seed``, a one-element int64
tensor on the waves' device, which the kernel reads itself: the host
never waits for its value.  The noise of a sample depends on the seed
and on its (utterance, frame, sample) position in the call, not on the
launch grid or the plan: the same seed gives the same bits, and one
call on a batch does NOT equal two calls on its halves (the second half
would repeat the first half's noise).  The plain version draws
``torch.randn`` from a generator seeded with the same number, or takes
``noise``: the two agree in distribution, not in bits.
"""

import ctypes
from typing import List, Optional, Tuple

import numpy as np
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


# the padded sizes the FFT plan takes; its blocks take FFT_FLOATS /
# n_fft frames (two blocks an SM at 512)
FFT_SIZES = (128, 256, 512, 1024, 2048)
FFT_FLOATS = 16384
# the FFT plan takes bins below LOW_BINS from the folded operator's
# columns (``kLowBins``): there the preemphasis leaves a quiet band whose
# few bins an FFT would round relative to the loudest
LOW_BINS = 16


def fbank_plan(n_fft: Optional[int]) -> str:
    """The kernel a CUDA call runs: "fft" for a padded size in
    ``FFT_SIZES``, "dense" for any other (or none given)."""
    return "fft" if n_fft in FFT_SIZES else "dense"


def fft_frames(n_fft: int) -> int:
    """Frames a block of the FFT plan takes (``fused_fbank_fft_frames``
    in csrc/fused_frontend.cu)."""
    if n_fft not in FFT_SIZES:
        raise ValueError(f"no FFT plan for n_fft {n_fft}")
    return FFT_FLOATS // n_fft


def fft_radices(n_fft: int) -> List[int]:
    """The radices of the kernel's Stockham stages for the complex FFT
    of n_fft / 2 points: radix 16 while 16 points or more remain, then
    the rest (``fft_stages``)."""
    n, out = n_fft // 2, []
    while n >= 16:
        out.append(16)
        n //= 16
    if n > 1:
        out.append(n)
    return out


def twiddle_table(n_fft: int) -> torch.Tensor:
    """(n_fft, 2) float32 [cos, -sin] of 2 pi m / n_fft: W^m =
    exp(-2 pi i m / n_fft), computed in float64 and rounded once."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return torch.from_numpy(
        np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32))


def mel_bands(mel_t: torch.Tensor, dense: bool = False
              ) -> Tuple[torch.Tensor, int]:
    """(M, 3) int32 [lo, hi, offset] of each filter's nonzero bins of
    ``mel_t`` (nbin, M), the offsets packing the filters' weights one
    after another, and the packed length.  ``dense`` gives every filter
    all bins.  Computed once, on the host."""
    w = mel_t.detach().to("cpu").numpy()
    nbin, n_mel = w.shape
    rows, off = [], 0
    for m in range(n_mel):
        nz = np.flatnonzero(w[:, m])
        lo, hi = ((0, nbin) if dense or nz.size == 0
                  else (int(nz[0]), int(nz[-1]) + 1))
        rows.append((lo, hi, off))
        off += hi - lo
    return torch.tensor(rows, dtype=torch.int32), off


def low_operator(analysis: torch.Tensor) -> torch.Tensor:
    """(round_up(frame_length, 32), 2 LOW_BINS) float32: the folded
    operator's columns of bins 0 .. LOW_BINS - 1 as [re, im] pairs, zero
    rows past the frame, what the FFT plan reads for its low bins (a
    warp four floats of a row, 32 rows at a time)."""
    fl, nbin = analysis.shape[0], analysis.shape[1] // 2
    low = analysis.new_zeros((-(-fl // 32) * 32, LOW_BINS, 2))
    low[:fl, :, 0] = analysis[:, :LOW_BINS]
    low[:fl, :, 1] = analysis[:, nbin:nbin + LOW_BINS]
    return low.reshape(low.shape[0], 2 * LOW_BINS)


def fft_smem_bytes(n_fft: int, frame_length: int, n_band: int,
                   n_mel: int) -> int:
    """Shared memory a block of the FFT plan takes
    (``fused_fbank_fft_smem_bytes``): twiddles, ``fft_frames`` frames
    (one pad a 16 complex points and two floats a frame), window, packed
    mel weights, the bands, the log-mel tile, the low bins' power, two
    chunks of 32 rows of ``low``."""
    def r4(v):
        return (v + 3) & ~3

    frames = fft_frames(n_fft)
    frame = 2 * (n_fft // 2 + n_fft // 32) + 2
    return 4 * (2 * n_fft + frames * frame + r4(frame_length) + r4(n_band)
                + r4(3 * n_mel) + frames * n_mel + frames * LOW_BINS
                + 2 * 32 * 2 * LOW_BINS)


def _lib():
    lib = cuda_build.load("fused_frontend")
    if lib.fused_fbank_dense_launch.argtypes is None:
        # without argtypes ctypes cuts pointers to int
        lib.fused_fbank_dense_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_void_p])
        lib.fused_fbank_dense_launch.restype = ctypes.c_int
        lib.fused_fbank_fft_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_float]
            + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
        lib.fused_fbank_fft_launch.restype = ctypes.c_int
        lib.fused_fbank_error_string.argtypes = [ctypes.c_int]
        lib.fused_fbank_error_string.restype = ctypes.c_char_p
    return lib


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
    n_fft: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
    twiddles: Optional[torch.Tensor] = None,
    low: Optional[torch.Tensor] = None,
    bands: Optional[torch.Tensor] = None,
    n_band: Optional[int] = None,
) -> torch.Tensor:
    """(B, S) float32 waves -> (B, T, D) features.

    ``analysis`` is the folded ``(frame_length, 2 * nbin)`` re|im DFT
    operator, ``mel_t`` the ``(nbin, M)`` mel bank, ``dct_t`` the
    optional ``(M, C)`` DCT for MFCC; all float32 and contiguous on the
    waves' device.  ``seed`` (one int64 element on that device) is read
    only when ``dither > 0``.  The FFT plan's operands, on the same
    device: ``n_fft`` (2 * (nbin - 1)), ``window`` (frame_length,)
    float32, ``twiddles`` (n_fft, 2) float32 from ``twiddle_table``,
    ``low`` (frame_length rounded up to 32, 2 LOW_BINS) float32 from
    ``low_operator``,
    ``bands`` (M, 3) int32 and ``n_band`` from ``mel_bands``;
    ``preemphasis`` and ``remove_dc_offset`` as the configuration has
    them.  An ``n_fft`` in ``FFT_SIZES`` takes the FFT plan, which needs
    them all; without ``n_fft`` (or with another size) the dense plan
    runs on ``analysis``.  Where given they are checked on any device
    (``n_band`` against ``bands`` only on the CPU: on the card that
    would wait for the device)."""
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
    if n_fft is not None:
        if n_fft < frame_length or n_fft // 2 + 1 != nbin:
            raise ValueError(f"n_fft {n_fft} must be at least frame_length "
                             f"{frame_length} and give nbin {nbin}")
        if window is not None:
            check_tensor("window", window, (frame_length,), dev)
        if twiddles is not None:
            check_tensor("twiddles", twiddles, (n_fft, 2), dev)
        if low is not None:
            check_tensor("low", low, (-(-frame_length // 32) * 32,
                                      2 * LOW_BINS), dev)
        if bands is not None:
            check_tensor("bands", bands, (n_mel, 3), dev, torch.int32)
            if n_band is None or n_band < 1:
                raise ValueError("bands need n_band, the packed length")
            if dev.type == "cpu":
                lo, hi, off = bands[-1].tolist()
                if n_band != off + hi - lo:
                    raise ValueError(f"n_band {n_band} does not match bands "
                                     f"({off + hi - lo})")
    use_fft = fbank_plan(n_fft) == "fft"
    if use_fft and any(v is None for v in (window, twiddles, low, bands)):
        raise ValueError("the FFT plan needs n_fft, window, twiddles, low, "
                         "bands and n_band (FeatureExtractor builds them)")
    t = _num_frames(s, frame_length, frame_shift)
    if t == 0:  # nothing to compute
        return waves.new_zeros((b, 0, out_dim))
    if dev.type == "cpu":
        return fused_fbank_plain(
            waves, analysis, mel_t, dct_t, frame_length=frame_length,
            frame_shift=frame_shift, dither=dither, seed=seed,
            use_power=use_power, use_log=use_log, epsilon=epsilon)
    lib = _lib()
    out = torch.empty((b, t, out_dim), dtype=torch.float32, device=dev)
    dct_ptr = dct_t.data_ptr() if dct_t is not None else None
    seed_ptr = seed.data_ptr() if dither > 0.0 else None
    flags = (int(bool(use_power)), int(bool(use_log)), float(epsilon))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if use_fft:
            err = lib.fused_fbank_fft_launch(
                waves.data_ptr(), window.data_ptr(), twiddles.data_ptr(),
                low.data_ptr(), mel_t.data_ptr(), bands.data_ptr(),
                dct_ptr, seed_ptr,
                out.data_ptr(), b, s, t, frame_length, frame_shift, n_fft,
                n_mel, out_dim, n_band, dither, float(preemphasis), int(bool(remove_dc_offset)),
                *flags, stream)
        else:
            err = lib.fused_fbank_dense_launch(
                waves.data_ptr(), analysis.data_ptr(), mel_t.data_ptr(),
                dct_ptr, seed_ptr, out.data_ptr(), b, s, t, frame_length,
                frame_shift, nbin, n_mel, out_dim, dither, *flags, stream)
    if err != 0:
        msg = lib.fused_fbank_error_string(err).decode()
        raise RuntimeError(f"fused_fbank kernel launch failed: {msg} ({err})")
    fused_fbank.launches += 1
    return out


fused_fbank.launches = 0
