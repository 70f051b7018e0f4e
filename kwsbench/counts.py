"""The yardstick: published peaks and the least work of each piece.

A roofline share is the least time the work could take on the card
over the device time of the kernels that do it.  The least time is the
largest of three: the products' operations at the peak of the precision
the configuration states (bf16 products at the bf16 tensor-core peak,
float32 products at the TF32 tensor-core peak, the highest that any
float32-accurate kernel can reach), every other operation at the
float32 peak outside the tensor cores, and the least bytes (each input
read once, each output written once) at the memory bandwidth.  The
counts are of the work, not of one implementation's passes, so a change
that splits or fuses kernels leaves them as they are.  An FMA counts 2.
"""

import math

# NVIDIA H100 SXM5 80 GB data sheet, dense rates without sparsity,
# at the 700 W board power
PEAKS = {
    "bfloat16": 989e12,   # tensor cores, bf16 in, fp32 accumulate
    "float32": 495e12,    # tensor cores, TF32
    "elementwise": 67e12,  # fp32 outside the tensor cores
    "bytes": 3.35e12,     # HBM3
}


def least_ms(products: float, elementwise: float, nbytes: float,
             precision: str) -> float:
    """The least time in ms of work of ``products`` and ``elementwise``
    operations and ``nbytes`` bytes, products at ``precision``'s peak."""
    return 1e3 * max(products / PEAKS[precision],
                     elementwise / PEAKS["elementwise"],
                     nbytes / PEAKS["bytes"])


def fbank(b: int, s: int, frame_length: int, frame_shift: int, n_fft: int,
          n_band: int, n_mel: int, n_out: int, mfcc: bool):
    """One feature call over (B, S) float32 waves: per frame the
    pre-chain 4 FL (mean, preemphasis, window), a real FFT of n_fft
    points 2.5 n log2 n, the power 3 (n/2 + 1), mel over the filters'
    nonzero bins 2 n_band, the log M; for MFCC the DCT, a product of
    2 M C.  Bytes: the waves read, the features written."""
    rows = b * (1 + (s - frame_length) // frame_shift)
    elementwise = rows * (4 * frame_length + 2.5 * n_fft * math.log2(n_fft)
                          + 3 * (n_fft // 2 + 1) + 2 * n_band + n_mel)
    products = rows * 2 * n_mel * n_out if mfcc else 0
    nbytes = 4 * (b * s + rows * n_out)
    return products, elementwise, nbytes


def model_forward_flops(model: dict, input_dim: int) -> float:
    """The DS-TCN's operations a frame, forward: the preprocessing's
    product, each layer's depthwise conv and pointwise product, the
    head."""
    bconf = model["backbone"]
    h = model["hidden_dim"]
    k = bconf.get("kernel_size", 8)
    flops = 2 * input_dim * h + 2 * h * model["output_dim"]
    flops += bconf["num_layers"] * (2 * k * h + 2 * h * h)
    return float(flops)
