"""Activation-range calibration for static int8 quantization.

The port's copy of wekws_tpu/export/calibrate.py.  One departure:
``feats_from_waves`` runs the port's ``StreamingFrontend``, which
computes MFCC for an MFCC config where the JAX package's computes fbank
(ROADMAP C.10), so an MFCC model is calibrated on the features it is
served (ROADMAP C.16).  Equivalent of the reference's observer pass
(the reference wekws's bin/static_quantize.py:57-130: fbgemm
MinMax/Histogram observers inserted by torch.quantization.prepare and
driven over the test set).  Here the observers are a callback on the
numpy graph interpreter: every SSA buffer's min/max (optionally a
percentile envelope) is recorded while the float artifact runs over a
calibration set, then converted to affine int8 (scale, zero_point)
pairs.

The zero point is chosen so that 0.0 is exactly representable (zero
padding and ReLU floors quantize without bias), matching the standard
affine-uint8/int8 scheme.

Default is min/max.  Measured on the trained synthetic FSMN CTC
model: percentile clipping makes things WORSE (max logit deviation
2.0 min/max -> 7.4 at 99.9% -> 28.8 at 99.5%) — these small models
carry meaningful activation outliers, so clip-based ranges trade a
little resolution everywhere for large errors on exactly the frames
that matter.  ``percentile`` stays available for corpora where
min/max is dominated by junk outliers.
"""

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


class RangeObserver:
    """Per-buffer running min/max (or percentile) collector."""

    def __init__(self, percentile: Optional[float] = None):
        self.percentile = percentile
        self.lo: Dict[int, float] = {}
        self.hi: Dict[int, float] = {}

    def __call__(self, buf_id: int, arr: np.ndarray) -> None:
        if arr.size == 0:
            return
        if self.percentile is not None:
            lo = float(np.percentile(arr, 100.0 - self.percentile))
            hi = float(np.percentile(arr, self.percentile))
        else:
            lo = float(arr.min())
            hi = float(arr.max())
        self.lo[buf_id] = min(self.lo.get(buf_id, lo), lo)
        self.hi[buf_id] = max(self.hi.get(buf_id, hi), hi)

    def ranges(self) -> Dict[int, Tuple[float, float]]:
        return {b: (self.lo[b], self.hi[b]) for b in self.lo}


def affine_qparams(lo: float, hi: float) -> Tuple[float, int]:
    """(scale, zero_point) mapping [lo, hi] onto int8 [-128, 127] with
    0.0 exactly representable."""
    lo = min(lo, 0.0)
    hi = max(hi, 0.0)
    scale = (hi - lo) / 255.0
    if scale <= 0.0:
        return 1e-8, 0
    zp = int(round(-128.0 - lo / scale))
    return scale, max(-128, min(127, zp))


def calibrate_activation_ranges(
    model_dir: str,
    calib_feats: Iterable[np.ndarray],
    percentile: Optional[float] = None,
) -> Dict[int, Tuple[float, int]]:
    """Run the float artifact over ``calib_feats`` ((T, D) feature
    matrices) and return {buffer_id: (scale, zero_point)}."""
    from wekws_tpu_torch.export.np_runtime import GraphRuntime

    rt = GraphRuntime(model_dir)
    obs = RangeObserver(percentile)
    n = 0
    for feats in calib_feats:
        rt.forward(np.asarray(feats, np.float32), observer=obs)
        n += 1
    if n == 0:
        raise ValueError("calibration set is empty")
    return {b: affine_qparams(lo, hi) for b, (lo, hi) in obs.ranges().items()}


def feats_from_waves(
    model_dir: str, waves: Iterable[np.ndarray], sample_rate: int = 16000
) -> List[np.ndarray]:
    """Waveforms -> model-input feature matrices using the artifact's
    embedded frontend config (fbank/mfcc + context expansion + frame
    skip — the calibration distribution must match serving exactly)."""
    import dataclasses

    from wekws_tpu_torch.export.np_runtime import GraphRuntime
    from wekws_tpu_torch.frontend.features import frontend_from_dataset_conf
    from wekws_tpu_torch.runtime.streaming_frontend import StreamingFrontend

    rt = GraphRuntime(model_dir)
    dconf = rt.meta.get("dataset_conf", {})
    cfg = frontend_from_dataset_conf(dconf).cfg
    if cfg.dither:
        cfg = dataclasses.replace(cfg, dither=0.0)
    ce = (dconf.get("context_expansion_conf", {})
          if dconf.get("context_expansion") else {})
    out = []
    for w in waves:
        fe = StreamingFrontend(
            cfg,
            left_context=ce.get("left", 0),
            right_context=ce.get("right", 0),
            frame_skip=dconf.get("frame_skip", 1),
        )
        feats, _ = fe.accept_waveform(np.asarray(w, np.float32))
        out.append(feats)
    return out
