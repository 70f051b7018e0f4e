"""Frontend configuration from a wekws ``dataset_conf``.

The config half of wekws_tpu/frontend/features.py.  The device
``FeatureExtractor`` comes with the training slice; serving computes
features on the host with ``kaldi.compute_fbank_np``.
"""

from wekws_tpu_torch.frontend.kaldi import FrontendConfig


def frontend_from_dataset_conf(conf: dict) -> FrontendConfig:
    """Supports both config schemas of the reference: the legacy
    ``feature_extraction_conf`` (with ``feature_type``) and the
    ``feats_type`` + ``fbank_conf``/``mfcc_conf`` layout."""
    if "feature_extraction_conf" in conf:
        fc = conf["feature_extraction_conf"]
        ftype = fc.get("feature_type", "fbank")
    else:
        ftype = conf.get("feats_type", "fbank")
        fc = conf.get(f"{ftype}_conf", {})
    resample = conf.get("resample_conf", {}).get("resample_rate", 16000)
    return FrontendConfig(
        feature_type=ftype,
        sample_rate=resample,
        num_mel_bins=fc.get("num_mel_bins", 40),
        num_ceps=fc.get("num_ceps", fc.get("num_mel_bins", 40)),
        frame_length_ms=fc.get("frame_length", 25),
        frame_shift_ms=fc.get("frame_shift", 10),
        dither=fc.get("dither", 0.0),
        dither_mode=fc.get("dither_mode", "frame"),
        precision=fc.get("precision", "high"),
    )
