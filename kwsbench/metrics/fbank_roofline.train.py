"""``fused_fbank`` (``csrc/fused_frontend.cu``): one call a unit over
the unit's waves, against its device time."""
from kwsbench import layers


def read(cell):
    return layers.roofline_pct(cell, layers.fbank_work(cell), "float32",
                               layers.FBANK_KERNELS)
