"""What the per-layer readers share: the port's kernel names by layer,
and the least work of a traced unit (a training step) at the cell's
shapes (``kwsbench.counts``)."""

from typing import Iterable, Optional

from kwsbench import counts
from kwsbench.reference import frontend as ref_frontend

# the hand-written kernels, each in its source's anonymous namespace
FBANK_KERNELS = ("fused_fbank_kernel",
                 "fused_fbank_dense_kernel")  # fused_frontend.cu


def is_port_kernel(name: str, names: Iterable[str]) -> bool:
    """Whether a profiler's kernel name is one of ``names`` in an
    anonymous namespace, demangled or not."""
    for k in names:
        if f"(anonymous namespace)::{k}<" in name \
                or f"(anonymous namespace)::{k}(" in name:
            return True
        if "_GLOBAL__N_" in name and f"{len(k)}{k}" in name:
            return True
    return False


def port_seconds(cell, names) -> Optional[float]:
    red = cell.layer.get("trace")
    if red is None:
        return None
    s = 1e-6 * sum(d for n, _, d in red.in_window(red.kernels)
                   if is_port_kernel(n, names))
    return s if s > 0 else None


def frames(cell) -> int:
    feats = ref_frontend.Features(cell.config["dataset_conf"], "cpu")
    return feats.num_frames(cell.layer["samples"])


def fbank_work(cell):
    """One feature call over the unit's batch."""
    dc = cell.config["dataset_conf"]
    f = ref_frontend.Features(dc, "cpu")
    n_band = int((f.bank > 0).sum())
    return counts.fbank(cell.layer["batch"], cell.layer["samples"],
                        f.frame_length, f.frame_shift, f.n_fft, n_band,
                        f.num_mel, f.dim, f.mfcc)


def roofline_pct(cell, work, precision: str, names) -> Optional[float]:
    """100 x the least time of ``work`` a unit, over the traced units,
    over the device time of the kernels ``names``."""
    dev_s = port_seconds(cell, names)
    if dev_s is None:
        return None
    least_s = 1e-3 * counts.least_ms(*work, precision) * cell.layer["units"]
    return 100.0 * least_s / dev_s


def idle_pct(cell) -> Optional[float]:
    red = cell.layer.get("trace")
    if red is None or red.window_s <= 0:
        return None
    return 100.0 * (1.0 - red.busy_s / red.window_s)


def host_ms(cell) -> Optional[float]:
    if cell.layer.get("thread_s") is None:
        return None
    return 1e3 * cell.layer["thread_s"] / cell.layer["units"]


def mfu_pct(cell, passes: int, precision: str) -> Optional[float]:
    """Model operations of the traced units (``passes`` = 3 for a
    forward and backward) over the traced wall time at the peak of the
    configuration's products."""
    red = cell.layer.get("trace")
    if red is None:
        return None
    conf = cell.layer["conf"]
    flops = passes * counts.model_forward_flops(conf, conf["input_dim"]) \
        * cell.layer["batch"] * frames(cell) * cell.layer["units"]
    return 100.0 * flops / (red.window_s * counts.PEAKS[precision])
